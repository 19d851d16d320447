"""Procedural benchmark scenes (the BASELINE ladder's conference/sponza/
museum class — the reference snapshot ships only killeroo/dodecahedron
geometry, so the >=1M-triangle rungs are generated deterministically).

`museum` builds a gallery: a matte floor/back wall, a grid of plastic
"statues" (noise-displaced UV spheres — dense, irregular, spatially
clustered triangles, the workload BVH treelets care about), one area light
panel overhead and a distant fill light. Geometry goes to a binary PLY and
a .pbrt references it, so the bench exercises the real ingestion path
(parser -> plymesh -> flatten -> upload).
"""

from __future__ import annotations

import os

import numpy as np

from tpupt_torch.scene.plyio import write_ply


def _hash_noise(p: np.ndarray, seed: int) -> np.ndarray:
    """Cheap deterministic value noise in [-1, 1] from 3D lattice hashing."""
    q = np.floor(p * 3.0).astype(np.int64)
    h = (q[..., 0] * 73856093 ^ q[..., 1] * 19349663
         ^ q[..., 2] * 83492791 ^ np.int64(seed) * 2654435761) & 0x7FFFFFFF
    return (h % 65536) / 32768.0 - 1.0


def _statue(seg: int, rings: int, center, scale: float, seed: int):
    """Noise-displaced UV sphere: (V,3) verts, (F,3) faces, (V,3) normals."""
    th = np.linspace(0, np.pi, rings + 1)
    ph = np.linspace(0, 2 * np.pi, seg, endpoint=False)
    T, PH = np.meshgrid(th, ph, indexing="ij")  # (rings+1, seg)
    n = np.stack([np.sin(T) * np.cos(PH), np.sin(T) * np.sin(PH),
                  np.cos(T)], -1)  # unit sphere
    disp = 1.0 + 0.22 * _hash_noise(n * 2.1, seed) \
        + 0.09 * _hash_noise(n * 5.3, seed + 1)
    P = n * disp[..., None] * scale + np.asarray(center)
    V = P.reshape(-1, 3)
    NV = n.reshape(-1, 3)

    def vid(r, s):
        return r * seg + (s % seg)

    faces = []
    r = np.arange(rings)[:, None]
    s = np.arange(seg)[None, :]
    a = vid(r, s)
    b = vid(r + 1, s)
    c = vid(r + 1, s + 1)
    d = vid(r, s + 1)
    faces = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([a, c, d], -1).reshape(-1, 3)])
    return V.astype(np.float32), faces.astype(np.int32), NV.astype(np.float32)


def museum(out_dir: str, grid: int = 8, seg: int = 96, rings: int = 48,
           seed: int = 7) -> str:
    """Write museum.ply + museum.pbrt under out_dir; returns the .pbrt path.

    Triangle count ~= grid^2 * seg * rings * 2 (defaults: 8*8*96*48*2 =
    589k statue tris) + 4 room tris; raise grid/seg/rings for the 1M rung
    (grid=8, seg=128, rings=64 -> 1.05M)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    verts, faces, normals = [], [], []
    voff = 0
    pitch = 3.0
    for gy in range(grid):
        for gx in range(grid):
            cx = (gx - (grid - 1) / 2) * pitch
            cy = (gy - (grid - 1) / 2) * pitch
            h = 1.0 + 0.3 * rng.random()
            V, F, NV = _statue(seg, rings, (cx, cy, h),
                               0.9 + 0.25 * rng.random(),
                               seed=seed * 1000 + gy * grid + gx)
            verts.append(V)
            faces.append(F + voff)
            normals.append(NV)
            voff += len(V)
    P = np.concatenate(verts)
    F = np.concatenate(faces)
    N = np.concatenate(normals)
    ply = os.path.join(out_dir, "museum.ply")
    write_ply(ply, P, F, N=N)

    half = grid * pitch / 2 + 4
    cam_d = grid * pitch * 1.1
    pbrt = os.path.join(out_dir, "museum.pbrt")
    with open(pbrt, "w") as f:
        f.write(f"""# generated by tpupt_torch.tools.genscene (deterministic seed {seed})
LookAt 0 {-cam_d:.2f} {grid * pitch * 0.45:.2f}  0 0 1  0 0 1
Camera "perspective" "float fov" [52]
Sampler "halton" "integer pixelsamples" [8]
Integrator "path" "integer maxdepth" [5]
Film "image" "integer xresolution" [1024] "integer yresolution" [1024]
WorldBegin
# ceiling light panel
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [14 13 11]
  Shape "trianglemesh" "point P" [-6 -6 {half:.2f}  6 -6 {half:.2f}  6 6 {half:.2f}  -6 6 {half:.2f}]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
LightSource "distant" "rgb L" [1.2 1.25 1.4] "point from" [-30 -40 50] "point to" [0 0 0]
# floor + back wall
Material "matte" "rgb Kd" [0.55 0.52 0.48]
Shape "trianglemesh" "point P" [{-half:.2f} {-half:.2f} 0  {half:.2f} {-half:.2f} 0  {half:.2f} {half:.2f} 0  {-half:.2f} {half:.2f} 0]
  "integer indices" [0 1 2 0 2 3]
Shape "trianglemesh" "point P" [{-half:.2f} {half:.2f} 0  {half:.2f} {half:.2f} 0  {half:.2f} {half:.2f} {half:.2f}  {-half:.2f} {half:.2f} {half:.2f}]
  "integer indices" [0 1 2 0 2 3]
# statues
Material "plastic" "rgb Kd" [0.32 0.30 0.34] "rgb Ks" [0.35 0.35 0.35] "float roughness" [0.08]
Shape "plymesh" "string filename" ["museum.ply"]
WorldEnd
""")
    return pbrt


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/tpupt_scenes"
    grid = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    seg = int(sys.argv[3]) if len(sys.argv) > 3 else 128
    rings = int(sys.argv[4]) if len(sys.argv) > 4 else 64
    print(museum(out, grid=grid, seg=seg, rings=rings))
