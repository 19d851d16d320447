"""The reference's own tables, worked out from the scene as plain data (a
generator's `scene`, e.g. `generators/museum.py`): triangles, materials,
lights, the spatial light-choice grid, the camera matrices and the
sampler's digit permutations. Nothing here reads a table the program
made."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MATTE, PLASTIC = 0, 1
AREA, DISTANT = 0, 1
GRID_RES = 16            # voxels a side of the spatial light-choice grid
SHADOW_EPS = 1e-3        # ray-origin offset, times max(|p|_inf, 1)
NEAR, FAR = 1e-2, 1000.0


def _primes(n: int):
    out, c = [], 2
    while len(out) < n:
        if all(c % p for p in out if p * p <= c):
            out.append(c)
        c += 1
    return out


PRIMES = _primes(256)


@dataclass
class RefScene:
    p0: torch.Tensor      # (T,3) float32
    p1: torch.Tensor
    p2: torch.Tensor
    n0: torch.Tensor      # (T,3) vertex normals (face normal where none)
    n1: torch.Tensor
    n2: torch.Tensor
    mat: torch.Tensor     # (T,) int64 material row
    light: torch.Tensor   # (T,) int64 light row or -1
    kd: torch.Tensor      # (M,3) the four tables a training step moves
    ks: torch.Tensor      # (M,3)
    rough: torch.Tensor   # (M,)
    light_L: torch.Tensor  # (NL,3)
    mat_type: torch.Tensor  # (M,) MATTE / PLASTIC
    mat_eta: torch.Tensor   # (M,)
    mat_remap: torch.Tensor  # (M,) bool
    light_type: torch.Tensor  # (NL,)
    light_prim: torch.Tensor  # (NL,) triangle of an area light
    light_dir: torch.Tensor   # (NL,3) toward a distant light
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    grid_cdf: torch.Tensor    # (G^3, NL)
    raster_to_camera: torch.Tensor  # (4,4)
    cam_to_world: torch.Tensor      # (4,4)
    xres: int
    yres: int
    max_depth: int
    rr_threshold: float
    perm_a: list
    perm_c: list


def _look_at(pos, look, up):
    """Camera-to-world of pbrt's LookAt (transform.cpp LookAt, inverted)."""
    pos, look, up = (np.asarray(v, np.float64) for v in (pos, look, up))
    d = look - pos
    d /= np.linalg.norm(d)
    u = up / np.linalg.norm(up)
    right = np.cross(u, d)
    right /= np.linalg.norm(right)
    new_up = np.cross(d, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, d, pos
    return m


def _raster_to_camera(fov, xres, yres):
    """Inverse of perspective camera-to-screen times screen-to-raster
    (perspective.cpp, camera.h ProjectiveCamera)."""
    frame = xres / yres
    if frame > 1.0:
        sx0, sx1, sy0, sy1 = -frame, frame, -1.0, 1.0
    else:
        sx0, sx1, sy0, sy1 = -1.0, 1.0, -1.0 / frame, 1.0 / frame
    inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, FAR / (FAR - NEAR), -FAR * NEAR / (FAR - NEAR)],
                      [0, 0, 1, 0]], np.float64)
    cam_to_screen = np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp
    screen_to_raster = (np.diag([xres, yres, 1.0, 1.0])
                        @ np.diag([1.0 / (sx1 - sx0), 1.0 / (sy0 - sy1),
                                   1.0, 1.0]))
    tr = np.eye(4)
    tr[0, 3], tr[1, 3] = -sx0, -sy1
    screen_to_raster = screen_to_raster @ tr
    return np.linalg.inv(cam_to_screen) @ np.linalg.inv(screen_to_raster)


def _grid_cdf(lights, tri, lo, hi):
    """Per-voxel light-choice cdfs: each light weighted at the voxel's
    centre by luminance x area / max(d^2, voxel diagonal^2) (area) or
    luminance x pi (distant); an all-zero voxel is uniform."""
    g = GRID_RES
    ax = [np.linspace(lo[a], hi[a], g, endpoint=False)
          + (hi[a] - lo[a]) / (2 * g) for a in range(3)]
    cx, cy, cz = np.meshgrid(*ax, indexing="ij")
    centers = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], -1)
    diag2 = float(np.sum((hi - lo) ** 2)) / (g * g)
    w = np.zeros((len(centers), len(lights)))
    for i, (kind, L, prim) in enumerate(lights):
        lum = 0.2126 * L[0] + 0.7152 * L[1] + 0.0722 * L[2]
        if kind == DISTANT:
            w[:, i] = lum * np.pi
        else:
            a, b, c = (x[prim].astype(np.float64) for x in tri)
            area = 0.5 * np.linalg.norm(np.cross(b - a, c - a))
            d2 = np.sum((centers - (a + b + c) / 3.0) ** 2, -1)
            w[:, i] = lum * area / np.maximum(d2, diag2)
    w = np.maximum(w, 0.0)
    tot = w.sum(-1, keepdims=True)
    pmf = np.where(tot > 0, w / np.maximum(tot, 1e-300), 1.0 / len(lights))
    return np.cumsum(pmf, -1).astype(np.float32)


def build(desc: dict, sampler_seed: int, device) -> RefScene:
    """RefScene of `desc` on `device`; `sampler_seed` seeds the digit
    permutations of the Halton dimensions."""
    mats = list(desc["materials"])
    p0s, p1s, p2s, n0s, n1s, n2s, mids, lids = ([] for _ in range(8))
    lights = []
    base = 0
    for m in desc["meshes"]:
        a, b, c = (np.asarray(x, np.float32) for x in m["p"])
        count = len(a)
        if m["n"] is None:
            fn = np.cross(b - a, c - a)
            fn = (fn / np.linalg.norm(fn, axis=-1, keepdims=True)).astype(
                np.float32)
            na = nb = nc = fn
        else:
            na, nb, nc = (np.asarray(x, np.float32) for x in m["n"])
        p0s.append(a), p1s.append(b), p2s.append(c)
        n0s.append(na), n1s.append(nb), n2s.append(nc)
        mids.append(np.full(count, mats.index(m["mat"])))
        lid = np.full(count, -1)
        if m["area_light"]:
            for k in range(count):
                lid[k] = len(lights)
                lights.append((AREA, desc["area_L"], base + k))
        lids.append(lid)
        base += count
    p0, p1, p2 = (np.concatenate(x) for x in (p0s, p1s, p2s))
    from_ = np.asarray(desc["distant_from"], np.float64)
    ldir_d = (from_ / np.linalg.norm(from_)).astype(np.float32)
    lights.append((DISTANT, desc["distant_L"], -1))
    pts = np.concatenate([p0, p1, p2])
    lo, hi = pts.min(0).astype(np.float32), pts.max(0).astype(np.float32)
    cdf = _grid_cdf(lights, (p0, p1, p2), lo, hi)
    xres, yres = desc["film"]
    cam = desc["camera"]
    r2c = _raster_to_camera(cam["fov"], xres, yres).astype(np.float32)
    c2w = _look_at(cam["pos"], cam["look"], cam["up"]).astype(np.float32)
    gen = np.random.default_rng(sampler_seed)
    perm_a = [int(gen.integers(1, p)) for p in PRIMES]
    perm_c = [int(gen.integers(0, p)) for p in PRIMES]

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    md = [desc["materials"][k] for k in mats]
    return RefScene(
        p0=t(p0), p1=t(p1), p2=t(p2),
        n0=t(np.concatenate(n0s)), n1=t(np.concatenate(n1s)),
        n2=t(np.concatenate(n2s)),
        mat=t(np.concatenate(mids), torch.int64),
        light=t(np.concatenate(lids), torch.int64),
        kd=t([m["kd"] for m in md]),
        ks=t([m.get("ks", (0.0, 0.0, 0.0)) for m in md]),
        rough=t([m.get("roughness", 0.0) for m in md]),
        light_L=t([L for _, L, _ in lights]),
        mat_type=t([PLASTIC if m["type"] == "plastic" else MATTE
                    for m in md], torch.int64),
        mat_eta=t([m.get("eta", 1.5) for m in md]),
        mat_remap=t([m.get("remap", True) for m in md], torch.bool),
        light_type=t([k for k, _, _ in lights], torch.int64),
        light_prim=t([max(p, 0) for _, _, p in lights], torch.int64),
        light_dir=t([ldir_d if k == DISTANT else np.zeros(3, np.float32)
                     for k, _, _ in lights]),
        world_lo=t(lo), world_hi=t(hi), grid_cdf=t(cdf),
        raster_to_camera=t(r2c), cam_to_world=t(c2w),
        xres=xres, yres=yres, max_depth=desc["max_depth"],
        rr_threshold=desc["rr_threshold"], perm_a=perm_a, perm_c=perm_c)
