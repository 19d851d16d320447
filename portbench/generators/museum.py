"""The museum scenes (`"generator": "museum"` in a configuration): a frozen
copy of the program's generator.

Source: `tpupt_torch/tools/genscene.py` (`_hash_noise`, `_statue`, `museum`)
and `tpupt_torch/scene/plyio.py` (`write_ply`) at commit 2f1d965. The
geometry is the same arithmetic, kept here so that the benchmark's scenes do
not move when the program's generator changes. Two changes from the source:
the film resolution is a parameter (the source writes 1024x1024), and
`museum_scene` returns the scene as plain arrays and numbers for the
reference, which reads no .pbrt file.

A generator module gives the harness `write_scene(config, xres, yres,
out_dir)` (the .pbrt path, its files written into out_dir unless there)
and `scene(config, xres, yres)` (the plain data for the reference).

The .pbrt names the geometry through a binary PLY, so the program's run
goes through its real ingestion path (parser -> plymesh -> flatten ->
upload)."""

from __future__ import annotations

import os

import numpy as np

PITCH = 3.0
FOV = 52.0
MAX_DEPTH = 5
AREA_L = (14.0, 13.0, 11.0)
DISTANT_L = (1.2, 1.25, 1.4)
DISTANT_FROM = (-30.0, -40.0, 50.0)
ROOM_KD = (0.55, 0.52, 0.48)
STATUE_KD = (0.32, 0.30, 0.34)
STATUE_KS = (0.35, 0.35, 0.35)
STATUE_ROUGHNESS = 0.08
DEFAULT_KD = (0.5, 0.5, 0.5)   # pbrt's default matte, taken by the light panel


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


def statues(grid: int, seg: int, rings: int, seed: int):
    """(P (V,3) f32, F (T,3) i32, N (V,3) f32) of the grid of statues."""
    rng = np.random.default_rng(seed)
    verts, faces, normals = [], [], []
    voff = 0
    for gy in range(grid):
        for gx in range(grid):
            cx = (gx - (grid - 1) / 2) * PITCH
            cy = (gy - (grid - 1) / 2) * PITCH
            h = 1.0 + 0.3 * rng.random()
            V, F, NV = _statue(seg, rings, (cx, cy, h),
                               0.9 + 0.25 * rng.random(),
                               seed=seed * 1000 + gy * grid + gx)
            verts.append(V)
            faces.append(F + voff)
            normals.append(NV)
            voff += len(V)
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(normals))


def _room(grid: int):
    """(half, camera distance, camera height), as the source rounds them
    into the .pbrt text (two decimals)."""
    half = round(grid * PITCH / 2 + 4, 2)
    cam_d = round(grid * PITCH * 1.1, 2)
    cam_h = round(grid * PITCH * 0.45, 2)
    return half, cam_d, cam_h


def write_ply(path: str, P: np.ndarray, indices: np.ndarray,
              N: np.ndarray) -> None:
    """Binary little-endian PLY with positions and normals."""
    P = np.asarray(P, "<f4")
    indices = np.asarray(indices, "<i4").reshape(-1, 3)
    props = ["property float x", "property float y", "property float z",
             "property float nx", "property float ny", "property float nz"]
    vert = np.concatenate([P, np.asarray(N, "<f4")], axis=1).astype("<f4")
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


def _write_atomic(path: str, write) -> None:
    """write(tmp) then rename onto path, so that no reader sees half a
    file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def write_scene(config: dict, xres: int, yres: int, out_dir: str) -> str:
    """museum.ply and the .pbrt at this film size under out_dir, each
    written unless it is there; returns the .pbrt's path."""
    os.makedirs(out_dir, exist_ok=True)
    ply = os.path.join(out_dir, "museum.ply")
    if not os.path.exists(ply):
        P, F, N = statues(config["grid"], config["seg"], config["rings"],
                          config["scene_seed"])
        _write_atomic(ply, lambda p: write_ply(p, P, F, N))
    pbrt = os.path.join(out_dir, f"museum_{xres}x{yres}.pbrt")
    if not os.path.exists(pbrt):
        text = pbrt_text(config["grid"], xres, yres)

        def write(p):
            with open(p, "w") as f:
                f.write(text)
        _write_atomic(pbrt, write)
    return pbrt


def scene(config: dict, xres: int, yres: int) -> dict:
    return museum_scene(config["grid"], config["seg"], config["rings"],
                        config["scene_seed"], xres, yres)


def pbrt_text(grid: int, xres: int, yres: int, spp: int = 8,
              ply: str = "museum.ply") -> str:
    """The .pbrt of the museum (the source's text; the film resolution and
    the sample count are parameters)."""
    half, cam_d, cam_h = _room(grid)
    return f"""# museum (portbench frozen generator)
LookAt 0 {-cam_d:.2f} {cam_h:.2f}  0 0 1  0 0 1
Camera "perspective" "float fov" [{FOV:g}]
Sampler "halton" "integer pixelsamples" [{spp}]
Integrator "path" "integer maxdepth" [{MAX_DEPTH}]
Film "image" "integer xresolution" [{xres}] "integer yresolution" [{yres}]
WorldBegin
# ceiling light panel
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [{AREA_L[0]:g} {AREA_L[1]:g} {AREA_L[2]:g}]
  Shape "trianglemesh" "point P" [-6 -6 {half:.2f}  6 -6 {half:.2f}  6 6 {half:.2f}  -6 6 {half:.2f}]
    "integer indices" [0 1 2 0 2 3]
AttributeEnd
LightSource "distant" "rgb L" [{DISTANT_L[0]:g} {DISTANT_L[1]:g} {DISTANT_L[2]:g}] "point from" [{DISTANT_FROM[0]:g} {DISTANT_FROM[1]:g} {DISTANT_FROM[2]:g}] "point to" [0 0 0]
# floor + back wall
Material "matte" "rgb Kd" [{ROOM_KD[0]:g} {ROOM_KD[1]:g} {ROOM_KD[2]:g}]
Shape "trianglemesh" "point P" [{-half:.2f} {-half:.2f} 0  {half:.2f} {-half:.2f} 0  {half:.2f} {half:.2f} 0  {-half:.2f} {half:.2f} 0]
  "integer indices" [0 1 2 0 2 3]
Shape "trianglemesh" "point P" [{-half:.2f} {half:.2f} 0  {half:.2f} {half:.2f} 0  {half:.2f} {half:.2f} {half:.2f}  {-half:.2f} {half:.2f} {half:.2f}]
  "integer indices" [0 1 2 0 2 3]
# statues
Material "plastic" "rgb Kd" [{STATUE_KD[0]:g} {STATUE_KD[1]:g} {STATUE_KD[2]:g}] "rgb Ks" [{STATUE_KS[0]:g} {STATUE_KS[1]:g} {STATUE_KS[2]:g}] "float roughness" [{STATUE_ROUGHNESS:g}]
Shape "plymesh" "string filename" ["{ply}"]
WorldEnd
"""


def museum_scene(grid: int, seg: int, rings: int, seed: int, xres: int,
                 yres: int) -> dict:
    """The same scene as plain data, for the reference: quads as two
    triangles each in the .pbrt's index order, the statues from the same
    arrays the PLY holds, materials, lights in declaration order (the
    panel's two triangles, then the distant light), camera and film."""
    half, cam_d, cam_h = _room(grid)
    f32 = np.float32

    def quad(pts):
        p = np.asarray(pts, f32)
        return p[[0, 0]], p[[1, 2]], p[[2, 3]]

    panel = quad([[-6, -6, half], [6, -6, half], [6, 6, half], [-6, 6, half]])
    floor = quad([[-half, -half, 0], [half, -half, 0], [half, half, 0],
                  [-half, half, 0]])
    wall = quad([[-half, half, 0], [half, half, 0], [half, half, half],
                 [-half, half, half]])
    P, F, N = statues(grid, seg, rings, seed)
    return dict(
        # (p0, p1, p2, per-vertex normals or None, material name, light ids)
        meshes=[
            dict(p=panel, n=None, mat="default", area_light=True),
            dict(p=floor, n=None, mat="room", area_light=False),
            dict(p=wall, n=None, mat="room", area_light=False),
            dict(p=(P[F[:, 0]], P[F[:, 1]], P[F[:, 2]]),
                 n=(N[F[:, 0]], N[F[:, 1]], N[F[:, 2]]), mat="statue",
                 area_light=False),
        ],
        materials=dict(
            default=dict(type="matte", kd=DEFAULT_KD),
            room=dict(type="matte", kd=ROOM_KD),
            statue=dict(type="plastic", kd=STATUE_KD, ks=STATUE_KS,
                        roughness=STATUE_ROUGHNESS, eta=1.5, remap=True)),
        area_L=AREA_L, distant_L=DISTANT_L, distant_from=DISTANT_FROM,
        camera=dict(pos=(0.0, -cam_d, cam_h), look=(0.0, 0.0, 1.0),
                    up=(0.0, 0.0, 1.0), fov=FOV),
        film=(xres, yres), max_depth=MAX_DEPTH, rr_threshold=1.0)
