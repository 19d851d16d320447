"""PLY mesh loading (counterpart of src/ext/rply + shapes/plymesh.cpp).

Supports ascii and binary_little_endian, vertex x/y/z (+nx/ny/nz, u/v or s/t)
and triangle/quad faces (quads split into two triangles)."""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str):
    """Returns dict with 'P' (V,3), optional 'N' (V,3), 'uv' (V,2), and
    'indices' (F,3) int32."""
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[data.find(b"\n", end) + 1 :]

    fmt = "ascii"
    elements: List[Tuple[str, int, List]] = []  # (name, count, props)
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
            else:
                elements[-1][2].append(("scalar", parts[1], parts[2]))

    verts: Dict[str, np.ndarray] = {}
    faces: List[List[int]] = []

    if fmt == "ascii":
        tokens = body.split()
        ti = 0
        for name, count, props in elements:
            if name == "vertex":
                cols = [p[2] for p in props]
                arr = np.array(tokens[ti : ti + count * len(cols)], dtype=np.float64)
                ti += count * len(cols)
                arr = arr.reshape(count, len(cols))
                for ci, cn in enumerate(cols):
                    verts[cn] = arr[:, ci]
            elif name == "face":
                for _ in range(count):
                    n = int(tokens[ti]); ti += 1
                    faces.append([int(tokens[ti + k]) for k in range(n)])
                    ti += n
            else:
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            n = int(tokens[ti]); ti += 1 + n
                        else:
                            ti += 1
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] == "scalar" for p in props):
                fmt_str = "<" + "".join(_PLY_TYPES[p[1]][0] for p in props)
                sz = struct.calcsize(fmt_str)
                raw = np.frombuffer(body, dtype=np.uint8, count=count * sz, offset=off)
                off += count * sz
                rec = np.frombuffer(raw.tobytes(), dtype=np.dtype(
                    [(p[2], "<" + _PLY_TYPES[p[1]][0]) for p in props]))
                for p in props:
                    verts[p[2]] = rec[p[2]].astype(np.float64)
            else:
                for _ in range(count):
                    face: Optional[List[int]] = None
                    for p in props:
                        if p[0] == "list":
                            cfmt, csz = _PLY_TYPES[p[1]]
                            (n,) = struct.unpack_from("<" + cfmt, body, off)
                            off += csz
                            ifmt, isz = _PLY_TYPES[p[2]]
                            vals = struct.unpack_from("<" + str(n) + ifmt, body, off)
                            off += n * isz
                            if p[3] in ("vertex_indices", "vertex_index"):
                                face = list(vals)
                        else:
                            off += _PLY_TYPES[p[1]][1]
                    if name == "face" and face is not None:
                        faces.append(face)
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    if "x" not in verts:
        raise ValueError(f"{path}: PLY has no vertex positions")
    out = {"P": np.stack([verts["x"], verts["y"], verts["z"]], -1)}
    if all(k in verts for k in ("nx", "ny", "nz")):
        out["N"] = np.stack([verts["nx"], verts["ny"], verts["nz"]], -1)
    for ukey, vkey in (("u", "v"), ("s", "t")):
        if ukey in verts and vkey in verts:
            out["uv"] = np.stack([verts[ukey], verts[vkey]], -1)
            break
    tris = []
    for f in faces:
        for k in range(1, len(f) - 1):  # fan-triangulate
            tris.append([f[0], f[k], f[k + 1]])
    out["indices"] = np.asarray(tris, np.int32).reshape(-1, 3)
    return out


def write_ply(path: str, P: np.ndarray, indices: np.ndarray,
              N: Optional[np.ndarray] = None,
              uv: Optional[np.ndarray] = None) -> None:
    """Write a binary_little_endian PLY (obj2pbrt/cyhair2pbrt-style tooling
    counterpart; also used by tools/genscene.py for benchmark geometry)."""
    P = np.asarray(P, "<f4")
    indices = np.asarray(indices, "<i4").reshape(-1, 3)
    props = ["property float x", "property float y", "property float z"]
    cols = [P]
    if N is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
        cols.append(np.asarray(N, "<f4"))
    if uv is not None:
        props += ["property float u", "property float v"]
        cols.append(np.asarray(uv, "<f4"))
    vert = np.concatenate(cols, axis=1).astype("<f4")
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0",
         f"element vertex {len(P)}"] + props +
        [f"element face {len(indices)}",
         "property list uchar int vertex_indices", "end_header", ""])
    face = np.empty((len(indices), 13), np.uint8)
    face[:, 0] = 3
    face[:, 1:] = indices.astype("<i4").view(np.uint8).reshape(-1, 12)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())
