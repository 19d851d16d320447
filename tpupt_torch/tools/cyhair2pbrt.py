"""cyhair2pbrt — convert Cem Yuksel .hair files to pbrt curve statements
(counterpart of src/tools/cyhair2pbrt.cpp and of the JAX package's
tools/cyhair2pbrt.py, whose file it writes byte for byte).

    python -m tpupt_torch.tools.cyhair2pbrt model.hair out.pbrt [--maxstrands N]

Emits one `Shape "curve"` per strand (cubic B-spline through the strand's
points, matching the reference's catmull-rom-to-bezier emission) wrapped in
a hair material whose color comes from the file's per-strand color when
present.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

HAS_SEGMENTS = 1
HAS_POINTS = 2
HAS_THICKNESS = 4
HAS_TRANSPARENCY = 8
HAS_COLOR = 16


def read_cyhair(path):
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"HAIR":
        raise ValueError(f"{path}: not a cyhair file (bad magic)")
    (n_strands, n_points, flags, d_segments) = struct.unpack_from("<IIII", data, 4)
    (d_thickness, d_transparency) = struct.unpack_from("<ff", data, 20)
    d_color = struct.unpack_from("<fff", data, 28)
    off = 128
    if flags & HAS_SEGMENTS:
        segments = np.frombuffer(data, "<u2", n_strands, off).astype(np.int64)
        off += 2 * n_strands
    else:
        segments = np.full(n_strands, d_segments, np.int64)
    if not flags & HAS_POINTS:
        raise ValueError("cyhair file without point data")
    points = np.frombuffer(data, "<f4", 3 * n_points, off).reshape(-1, 3)
    off += 12 * n_points
    if flags & HAS_THICKNESS:
        thickness = np.frombuffer(data, "<f4", n_points, off)
        off += 4 * n_points
    else:
        thickness = np.full(n_points, d_thickness, np.float32)
    if flags & HAS_TRANSPARENCY:
        off += 4 * n_points  # parsed but unused (as in the reference)
    if flags & HAS_COLOR:
        colors = np.frombuffer(data, "<f4", 3 * n_points, off).reshape(-1, 3)
    else:
        colors = np.broadcast_to(np.asarray(d_color, np.float32), (n_points, 3))
    return segments, points, thickness, colors


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--maxstrands", type=int, default=0)
    args = ap.parse_args(argv)
    segments, points, thickness, colors = read_cyhair(args.input)
    n = len(segments) if not args.maxstrands else min(args.maxstrands,
                                                      len(segments))
    with open(args.output, "w") as out:
        out.write(f"# converted from {args.input}: {n} strands\n")
        p0 = 0
        for s in range(n):
            np_pts = int(segments[s]) + 1
            pts = points[p0:p0 + np_pts]
            col = colors[p0:p0 + np_pts].mean(0)
            w0 = float(thickness[p0])
            w1 = float(thickness[p0 + np_pts - 1])
            p0 += np_pts
            if np_pts < 2:
                continue
            # pad to >= 4 control points for the cubic b-spline basis
            while len(pts) < 4:
                pts = np.concatenate([pts, pts[-1:]])
            pstr = " ".join(f"{v:.6g}" for v in pts.ravel())
            out.write(
                'Material "hair" "rgb color" '
                f"[{col[0]:.4g} {col[1]:.4g} {col[2]:.4g}]\n"
                'Shape "curve" "string basis" "bspline" "integer degree" [3] '
                f'"point P" [{pstr}] '
                f'"float width0" [{w0:.6g}] "float width1" [{w1:.6g}]\n')
    print(f"wrote {n} strands to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
