"""Image I/O: EXR (uncompressed scanline), PFM, PNG (via PIL), TGA.

Counterpart of src/core/imageio.cpp ReadImage/WriteImage (the reference links
OpenEXR/lodepng/targa; here EXR is a minimal self-contained codec for
FLOAT/HALF scanline images — enough for interchange with pbrt output)."""

from __future__ import annotations

import struct
import zlib
from typing import Dict

import numpy as np


# ------------------------------- gamma -------------------------------------


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * np.power(x, 1 / 2.4) - 0.055)


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92, np.power((x + 0.055) / 1.055, 2.4))


# ------------------------------- PNG ---------------------------------------


def write_png(path: str, img: np.ndarray, gamma: bool = True):
    """img: (H,W,3) float linear radiance -> 8-bit sRGB PNG."""
    from PIL import Image

    x = linear_to_srgb(img) if gamma else np.clip(img, 0, 1)
    Image.fromarray((x * 255.0 + 0.5).astype(np.uint8)).save(path)


def read_png(path: str, gamma: bool = True) -> np.ndarray:
    from PIL import Image

    x = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(x) if gamma else x


# ------------------------------- PFM ---------------------------------------


def write_pfm(path: str, img: np.ndarray):
    """(H,W,3) float32, PFM stores scanlines bottom-to-top (imageio.cpp
    WritePFM)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(img[::-1].tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline())
        dt = "<f4" if scale < 0 else ">f4"
        c = 3 if header == b"PF" else 1
        data = np.frombuffer(f.read(w * h * c * 4), dt).reshape(h, w, c)
        return data[::-1].astype(np.float32)


# ------------------------------- EXR ---------------------------------------

_EXR_MAGIC = 20000630
_PT_HALF, _PT_FLOAT = 1, 2


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray, half: bool = True):
    """Minimal OpenEXR 2.0 writer: single part, scanline, no compression,
    RGB in HALF (default) or FLOAT."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    pt = _PT_HALF if half else _PT_FLOAT
    pix_size = 2 if half else 4

    chans = b""
    for name in (b"B", b"G", b"R"):  # alphabetical per spec
        chans += name + b"\0" + struct.pack("<iiii", pt, 0, 1, 1)
    chans += b"\0"

    header = b""
    header += _exr_attr(b"channels", b"chlist", chans)
    header += _exr_attr(b"compression", b"compression", b"\0")  # NO_COMPRESSION
    header += _exr_attr(b"dataWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr(b"displayWindow", b"box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\0")  # INCREASING_Y
    header += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    offset_table_pos = len(preamble)
    first_scanline_pos = offset_table_pos + 8 * h

    scan_bytes = 8 + 3 * w * pix_size  # y + size + data
    offsets = [first_scanline_pos + i * scan_bytes for i in range(h)]

    if half:
        data = img[..., [2, 1, 0]].astype(np.float16)  # B, G, R planes
    else:
        data = img[..., [2, 1, 0]].astype(np.float32)

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * pix_size))
            f.write(data[y, :, 0].tobytes())  # B plane
            f.write(data[y, :, 1].tobytes())  # G
            f.write(data[y, :, 2].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Minimal EXR reader: single-part scanline, NO or ZIP/ZIPS compression,
    HALF/FLOAT channels (covers pbrt's default output)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR")
    if version & 0x200:
        raise ValueError(f"{path}: multi-part EXR unsupported")
    pos = 8
    attrs: Dict[str, bytes] = {}
    while buf[pos] != 0:
        e = buf.index(b"\0", pos)
        name = buf[pos:e].decode()
        pos = e + 1
        e = buf.index(b"\0", pos)
        typ = buf[pos:e].decode()
        pos = e + 1
        (sz,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = buf[pos : pos + sz]
        pos += sz
    pos += 1

    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][0]
    # parse channel list
    chans = []
    cpos = 0
    cl = attrs["channels"]
    while cl[cpos] != 0:
        e = cl.index(b"\0", cpos)
        cname = cl[cpos:e].decode()
        pt, _, _, _ = struct.unpack_from("<iiii", cl, e + 1)
        chans.append((cname, pt))
        cpos = e + 1 + 16
    chans_sorted = chans  # stored alphabetically already

    lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}.get(comp)
    if lines_per_block is None:
        raise ValueError(f"{path}: compression {comp} unsupported")
    n_blocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, pos)

    out = {name: np.zeros((h, w), np.float32) for name, _ in chans_sorted}
    for off in offsets:
        y, sz = struct.unpack_from("<ii", buf, off)
        raw = buf[off + 8 : off + 8 + sz]
        nlines = min(lines_per_block, h - (y - y0))
        expected = sum(
            (2 if pt == _PT_HALF else 4) * w for _, pt in chans_sorted) * nlines
        if comp in (2, 3):  # ZIPS/ZIP
            if sz < expected:
                raw = zlib.decompress(raw)
                # EXR zip predictor: delta + interleave
                arr = np.frombuffer(raw, np.uint8).astype(np.int64)
                arr = np.cumsum(np.concatenate([[arr[0]], (arr[1:] - 128)])) % 256
                half_len = (len(arr) + 1) // 2
                out_b = np.zeros(len(arr), np.uint8)
                out_b[0::2] = arr[:half_len].astype(np.uint8)
                out_b[1::2] = arr[half_len : half_len + len(arr) // 2].astype(np.uint8)
                raw = out_b.tobytes()
        p = 0
        for line in range(nlines):
            for cname, pt in chans_sorted:
                nbytes = (2 if pt == _PT_HALF else 4) * w
                dt = np.float16 if pt == _PT_HALF else np.float32
                vals = np.frombuffer(raw[p : p + nbytes], dt).astype(np.float32)
                out[cname][y - y0 + line] = vals
                p += nbytes

    if all(k in out for k in ("R", "G", "B")):
        return np.stack([out["R"], out["G"], out["B"]], -1)
    first = next(iter(out.values()))
    return first[..., None]
