"""Self-contained Ptex codec + per-face texture tables.

Counterpart of the reference's textures/ptex.{h,cpp} (which wraps the
external Ptex library — an EMPTY submodule dir in the snapshot, so the
reference itself cannot build this texture without fetching it; we instead
implement the published Ptex 2.x file layout directly, the same way
utils/imageio.py re-implements EXR instead of vendoring OpenEXR).

Reader scope (PtexReader parity for the renderer's needs):
  * header v1/v2 incl. ExtHeader skip,
  * zlib'd FaceInfo / const-data blocks,
  * level-0 face data in all four encodings: constant, zipped,
    diff-zipped (byte differencing then zlib), and tiled (per-tile
    headers, each tile constant/zipped/diffzipped),
  * data types uint8 / uint16 / half / float.
Unsupported or corrupt content degrades to the face's constant color with
a warning — mirroring ptex.cpp:84-92's Error-and-invalid behavior rather
than aborting the render.

Writer scope: single-level quad-mesh files with per-face zipped (or
constant) data — enough to author test fixtures and to give the framework
a ptex producer (the reference has none).

Runtime evaluation lives in textures/textures.py (TEX_PTEX): faces are
packed into the shared texel atlas and looked up by the hit triangle's
faceIndex (interaction.h:156; triangle.cpp:344 threads the mesh's
"faceIndices" into SurfaceInteraction), bilinear with clamped face edges
(the reference uses the Ptex b-spline filter with cross-face adjacency,
ptex.cpp:147 — a refinement that needs the adjface graph at eval time).
"""

from __future__ import annotations

import struct
import warnings
import zlib

import numpy as np

MAGIC = b"Ptex"

MT_TRIANGLE, MT_QUAD = 0, 1
DT_UINT8, DT_UINT16, DT_HALF, DT_FLOAT = 0, 1, 2, 3
_DTYPES = {DT_UINT8: np.uint8, DT_UINT16: np.uint16,
           DT_HALF: np.float16, DT_FLOAT: np.float32}
_DT_SCALE = {DT_UINT8: 255.0, DT_UINT16: 65535.0, DT_HALF: 1.0, DT_FLOAT: 1.0}

ENC_CONSTANT, ENC_ZIPPED, ENC_DIFFZIPPED, ENC_TILED = 0, 1, 2, 3

# Header: magic, version, meshtype, datatype, alphachan, nchannels,
# nlevels, nfaces, extheadersize, faceinfosize, constdatasize,
# levelinfosize, [4 pad], leveldatasize, metadataheadersize,
# metadatazipsize — 64 bytes with the C-struct padding before the u64.
_HDR = struct.Struct("<IIIIiHHIIIII4xQII")
_FACEINFO = struct.Struct("<bbBBiiii")  # res.ulog2, res.vlog2, adjedges,
#                                          flags, adjfaces[4] — 20 bytes
_LEVELINFO = struct.Struct("<QII")      # leveldatasize, levelheadersize,
#                                          nfaces — 16 bytes
FLAG_CONSTANT = 0x1


def _diff_decode(raw: bytes) -> np.ndarray:
    """Inverse of Ptex's byte differencing: out[i] = out[i-1] + in[i]."""
    return np.cumsum(np.frombuffer(raw, np.uint8), dtype=np.uint8)


def _diff_encode(data: np.ndarray) -> bytes:
    b = data.view(np.uint8).reshape(-1)
    return np.concatenate([b[:1], (b[1:] - b[:-1])]).tobytes()


def _to_float(texels: np.ndarray, dt: int) -> np.ndarray:
    return texels.astype(np.float32) / _DT_SCALE[dt]


def read_ptex(path: str):
    """Parse a .ptx file. Returns (faces, meshtype) where faces is a list
    of (resv, resu, nchannels) float32 arrays in [0,1] for integer types
    (raw value for half/float), one per face, top level only."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not a Ptex file")
    (magic, version, meshtype, datatype, alphachan, nchannels, nlevels,
     nfaces, extheadersize, faceinfosize, constdatasize, levelinfosize,
     leveldatasize, mdhs, mdzs) = _HDR.unpack_from(buf, 0)
    del magic, alphachan, mdhs, mdzs
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unknown datatype {datatype}")
    dt = _DTYPES[datatype]
    psize = nchannels * dt().itemsize

    pos = _HDR.size + extheadersize
    faceinfo_raw = zlib.decompress(buf[pos: pos + faceinfosize])
    pos += faceinfosize
    const_raw = zlib.decompress(buf[pos: pos + constdatasize]) \
        if constdatasize else b""
    pos += constdatasize
    levelinfo_raw = buf[pos: pos + levelinfosize]
    pos += levelinfosize
    leveldata = buf[pos: pos + leveldatasize]

    faces_info = [_FACEINFO.unpack_from(faceinfo_raw, i * _FACEINFO.size)
                  for i in range(nfaces)]
    const = (np.frombuffer(const_raw, dt).reshape(nfaces, nchannels)
             if len(const_raw) >= nfaces * psize else
             np.zeros((nfaces, nchannels), dt))

    def const_face(i, ru, rv):
        return np.broadcast_to(_to_float(const[i], datatype),
                               (rv, ru, nchannels)).copy()

    def decode_block(raw, enc, ru, rv, i):
        if enc == ENC_CONSTANT:
            return const_face(i, ru, rv)
        if enc == ENC_ZIPPED:
            data = np.frombuffer(zlib.decompress(raw), dt)
        elif enc == ENC_DIFFZIPPED:
            data = _diff_decode(zlib.decompress(raw)).view(dt)
        else:
            raise ValueError(f"nested encoding {enc}")
        if data.size != ru * rv * nchannels:
            raise ValueError("face texel count mismatch")
        return _to_float(data.reshape(rv, ru, nchannels), datatype)

    faces = []
    if nlevels < 1 or len(levelinfo_raw) < _LEVELINFO.size:
        return [const_face(i, 1 << max(fi[0], 0), 1 << max(fi[1], 0))
                for i, fi in enumerate(faces_info)], meshtype
    lsize, lhdrsize, lnfaces = _LEVELINFO.unpack_from(levelinfo_raw, 0)
    del lsize
    fdh = np.frombuffer(zlib.decompress(leveldata[:lhdrsize]), "<u4")
    off = lhdrsize
    for i in range(min(nfaces, lnfaces, len(fdh))):
        ulog2, vlog2, adjedges, flags = faces_info[i][:4]
        del adjedges
        ru, rv = 1 << max(ulog2, 0), 1 << max(vlog2, 0)
        size = int(fdh[i] & 0x3FFFFFFF)
        enc = int(fdh[i] >> 30)
        raw = leveldata[off: off + size]
        off += size
        try:
            if flags & FLAG_CONSTANT or enc == ENC_CONSTANT:
                faces.append(const_face(i, ru, rv))
            elif enc == ENC_TILED:
                tulog2, tvlog2 = struct.unpack_from("<bb", raw, 0)
                tru, trv = 1 << tulog2, 1 << tvlog2
                ntu, ntv = ru // tru, rv // trv
                (thsize,) = struct.unpack_from("<I", raw, 2)
                tfdh = np.frombuffer(
                    zlib.decompress(raw[6: 6 + thsize]), "<u4")
                face = np.zeros((rv, ru, nchannels), np.float32)
                toff = 6 + thsize
                for tj in range(ntv * ntu):
                    tsz = int(tfdh[tj] & 0x3FFFFFFF)
                    tenc = int(tfdh[tj] >> 30)
                    tile = (const_face(i, tru, trv) if tenc == ENC_CONSTANT
                            else decode_block(raw[toff: toff + tsz], tenc,
                                              tru, trv, i))
                    ty, tx = divmod(tj, ntu)
                    face[ty * trv:(ty + 1) * trv,
                         tx * tru:(tx + 1) * tru] = tile
                    toff += tsz
                faces.append(face)
            else:
                faces.append(decode_block(raw, enc, ru, rv, i))
        except Exception as e:  # corrupt face -> its constant color
            warnings.warn(f"{path}: face {i} undecodable ({e}); constant")
            faces.append(const_face(i, ru, rv))
    while len(faces) < nfaces:
        fi = faces_info[len(faces)]
        faces.append(const_face(len(faces), 1 << max(fi[0], 0),
                                1 << max(fi[1], 0)))
    return faces, meshtype


def write_ptex(path: str, faces, datatype: int = DT_UINT8,
               meshtype: int = MT_QUAD, tile: int = 0):
    """Write a single-level Ptex file. `faces`: list of (rv, ru, c) float
    arrays, [0,1] for integer datatypes; all power-of-two resolutions.
    `tile` > 0 writes enc_tiled faces with tile x tile tiles (for reader
    coverage); otherwise zipped (or constant where the face is flat)."""
    dt = _DTYPES[datatype]
    scale = _DT_SCALE[datatype]
    nchan = int(faces[0].shape[2]) if faces else 3
    nfaces = len(faces)

    def quant(a):
        a = np.asarray(a, np.float32)
        if datatype in (DT_UINT8, DT_UINT16):
            return np.round(np.clip(a, 0.0, 1.0) * scale).astype(dt)
        return a.astype(dt)

    fi_parts, const_parts, fdh, blobs = [], [], [], []
    for f in faces:
        rv, ru, c = f.shape
        assert c == nchan and (ru & (ru - 1)) == 0 and (rv & (rv - 1)) == 0
        q = quant(f)
        const_parts.append(quant(f.reshape(-1, c).mean(0)).tobytes())
        is_const = bool((q == q.reshape(-1, c)[0]).all())
        flags = FLAG_CONSTANT if is_const else 0
        fi_parts.append(_FACEINFO.pack(
            int(np.log2(ru)), int(np.log2(rv)), 0, flags, -1, -1, -1, -1))
        if is_const:
            fdh.append(ENC_CONSTANT << 30)
            blobs.append(b"")
        elif tile and ru > tile and rv > tile:
            ntu, ntv = ru // tile, rv // tile
            tfdh, tblobs = [], []
            for ty in range(ntv):
                for tx in range(ntu):
                    tq = q[ty * tile:(ty + 1) * tile,
                           tx * tile:(tx + 1) * tile]
                    z = zlib.compress(tq.tobytes())
                    tfdh.append((ENC_ZIPPED << 30) | len(z))
                    tblobs.append(z)
            th = zlib.compress(np.asarray(tfdh, "<u4").tobytes())
            body = (struct.pack("<bbI", int(np.log2(tile)),
                                int(np.log2(tile)), len(th))
                    + th + b"".join(tblobs))
            fdh.append((ENC_TILED << 30) | len(body))
            blobs.append(body)
        else:
            z = zlib.compress(_diff_encode(q)) \
                if datatype in (DT_UINT8, DT_UINT16) \
                else zlib.compress(q.tobytes())
            enc = (ENC_DIFFZIPPED if datatype in (DT_UINT8, DT_UINT16)
                   else ENC_ZIPPED)
            fdh.append((enc << 30) | len(z))
            blobs.append(z)

    faceinfo_z = zlib.compress(b"".join(fi_parts))
    const_z = zlib.compress(b"".join(const_parts))
    lvl_hdr_z = zlib.compress(np.asarray(fdh, "<u4").tobytes())
    lvl_data = lvl_hdr_z + b"".join(blobs)
    levelinfo = _LEVELINFO.pack(len(lvl_data), len(lvl_hdr_z), nfaces)

    hdr = _HDR.pack(struct.unpack("<I", MAGIC)[0], 1, meshtype, datatype,
                    -1, nchan, 1, nfaces, 0, len(faceinfo_z), len(const_z),
                    len(levelinfo), len(lvl_data), 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + faceinfo_z + const_z + levelinfo + lvl_data)
