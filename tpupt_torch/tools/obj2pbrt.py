"""Wavefront OBJ -> .pbrt converter (counterpart of src/tools/obj2pbrt.cpp
and of the JAX package's tools/obj2pbrt.py, whose file it writes byte for
byte, its header line included).

    python -m tpupt_torch.tools.obj2pbrt scene.obj scene.pbrt

Emits one trianglemesh shape per OBJ material (faces fan-triangulated,
vertices pooled per material, normals and uvs where every face has them),
matte by default, plastic where the .mtl gives a Ks, with the .mtl's Kd.
Text only."""

from __future__ import annotations

import os
import sys


def load_mtl(path):
    mats = {}
    cur = None
    if not os.path.isfile(path):
        return mats
    for line in open(path, errors="replace"):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "newmtl":
            cur = parts[1]
            mats[cur] = {"Kd": (0.5, 0.5, 0.5)}
        elif parts[0] == "Kd" and cur:
            mats[cur]["Kd"] = tuple(float(x) for x in parts[1:4])
        elif parts[0] == "Ks" and cur:
            mats[cur]["Ks"] = tuple(float(x) for x in parts[1:4])
        elif parts[0] == "Ns" and cur:
            mats[cur]["Ns"] = float(parts[1])
    return mats


def convert(obj_path, out_path):
    verts, norms, uvs = [], [], []
    groups = {}  # material -> list of (vidx, nidx, tidx) triangles
    cur_mat = ""
    mtl = {}
    for line in open(obj_path, errors="replace"):
        parts = line.split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v":
            verts.append(tuple(float(x) for x in parts[1:4]))
        elif parts[0] == "vn":
            norms.append(tuple(float(x) for x in parts[1:4]))
        elif parts[0] == "vt":
            uvs.append(tuple(float(x) for x in parts[1:3]))
        elif parts[0] == "mtllib":
            mtl.update(load_mtl(os.path.join(os.path.dirname(obj_path),
                                             parts[1])))
        elif parts[0] == "usemtl":
            cur_mat = parts[1]
        elif parts[0] == "f":
            idx = []
            for v in parts[1:]:
                comps = (v.split("/") + ["", ""])[:3]
                vi = int(comps[0])
                ti = int(comps[1]) if comps[1] else 0
                ni = int(comps[2]) if comps[2] else 0
                idx.append((vi, ti, ni))
            for k in range(1, len(idx) - 1):  # fan-triangulate
                groups.setdefault(cur_mat, []).append(
                    (idx[0], idx[k], idx[k + 1]))

    def resolve(i, n):
        return i - 1 if i > 0 else n + i

    with open(out_path, "w") as f:
        f.write(f"# converted from {os.path.basename(obj_path)} by "
                "tpupt obj2pbrt\n")
        for mat, tris in groups.items():
            f.write("AttributeBegin\n")
            kd = mtl.get(mat, {}).get("Kd", (0.5, 0.5, 0.5))
            ks = mtl.get(mat, {}).get("Ks")
            if ks and sum(ks) > 0.01:
                f.write(f'Material "plastic" "color Kd" '
                        f'[{kd[0]} {kd[1]} {kd[2]}] '
                        f'"color Ks" [{ks[0]} {ks[1]} {ks[2]}]\n')
            else:
                f.write(f'Material "matte" "color Kd" '
                        f'[{kd[0]} {kd[1]} {kd[2]}]\n')
            # build local vertex pool
            pool = {}
            order = []
            for tri in tris:
                for (vi, ti, ni) in tri:
                    key = (vi, ti, ni)
                    if key not in pool:
                        pool[key] = len(order)
                        order.append(key)
            f.write('Shape "trianglemesh"\n  "point P" [')
            for (vi, ti, ni) in order:
                x, y, z = verts[resolve(vi, len(verts))]
                f.write(f" {x} {y} {z}")
            f.write(" ]\n")
            if norms and all(ni != 0 for tri in tris for (_, _, ni) in tri):
                f.write('  "normal N" [')
                for (vi, ti, ni) in order:
                    x, y, z = norms[resolve(ni, len(norms))]
                    f.write(f" {x} {y} {z}")
                f.write(" ]\n")
            if uvs and all(ti != 0 for tri in tris for (_, ti, _) in tri):
                f.write('  "float uv" [')
                for (vi, ti, ni) in order:
                    u, v = uvs[resolve(ti, len(uvs))]
                    f.write(f" {u} {v}")
                f.write(" ]\n")
            f.write('  "integer indices" [')
            for tri in tris:
                for key in tri:
                    f.write(f" {pool[key]}")
            f.write(" ]\n")
            f.write("AttributeEnd\n")
    n_tris = sum(len(t) for t in groups.values())
    print(f"wrote {out_path}: {len(verts)} vertices, {n_tris} triangles, "
          f"{len(groups)} material groups")


def main(argv=None):
    args = (argv or sys.argv[1:])
    if len(args) != 2:
        print("usage: obj2pbrt scene.obj scene.pbrt", file=sys.stderr)
        return 1
    convert(args[0], args[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
