"""Watertight ray-triangle intersection over SoA tensors.

Same algorithm as the reference's Triangle::Intersect (shapes/triangle.cpp:
188-427, Woop et al. style): translate to ray origin, permute so the dominant
ray axis is z, shear to align the ray with +z, then signed 2D edge functions.

The reference falls back to double precision when an edge function is
exactly zero. The JAX package writes that recompute with a float64 cast, but
it never enables 64-bit mode, so its cast is a no-op and the recompute gives
the float32 value again. This port matches the JAX package (the parity tests
decide), so there is no recompute here: a real double-precision one would
differ from it exactly on the zero-edge rays."""

from __future__ import annotations

import torch


def _sel_axis(p, k):
    """p[..., k] for a per-ray axis k in {0,1,2}."""
    return torch.where(k == 0, p[..., 0],
                       torch.where(k == 1, p[..., 1], p[..., 2]))


def ray_permutation(d):
    """Per-ray permutation + shear constants (triangle.cpp:205-221).
    Returns (kx, ky, kz, sx, sy, sz), each (...,). With two equal largest
    components kz is the first of them."""
    ad = torch.abs(d)
    # first maximum, spelled out: torch.argmax leaves the tie order open
    kz = torch.where((ad[..., 0] >= ad[..., 1]) & (ad[..., 0] >= ad[..., 2]), 0,
                     torch.where(ad[..., 1] >= ad[..., 2], 1, 2))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = _sel_axis(d, kz)
    swap = dz < 0.0
    kx2 = torch.where(swap, ky, kx)
    ky2 = torch.where(swap, kx, ky)
    dx = _sel_axis(d, kx2)
    dy = _sel_axis(d, ky2)
    sx = dx / dz
    sy = dy / dz
    sz = 1.0 / dz
    return kx2, ky2, kz, sx, sy, sz


def _permute(p, kx, ky, kz):
    return _sel_axis(p, kx), _sel_axis(p, ky), _sel_axis(p, kz)


def intersect_triangle(o, perm, p0, p1, p2, tmax):
    """Watertight test. `perm` from ray_permutation; o (...,3) ray origins;
    p0/p1/p2 (...,3) triangle vertices (broadcastable against rays).

    Returns (hit, t, b0, b1, b2) with barycentrics w.r.t. (p0, p1, p2)."""
    kx, ky, kz, sx, sy, sz = perm
    a0x, a0y, a0z = _permute(p0 - o, kx, ky, kz)
    a1x, a1y, a1z = _permute(p1 - o, kx, ky, kz)
    a2x, a2y, a2z = _permute(p2 - o, kx, ky, kz)

    x0 = a0x - sx * a0z
    y0 = a0y - sy * a0z
    x1 = a1x - sx * a1z
    y1 = a1y - sy * a1z
    x2 = a2x - sx * a2z
    y2 = a2y - sy * a2z

    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1

    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) \
        | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    det = e0 + e1 + e2

    z0 = sz * a0z
    z1 = sz * a1z
    z2 = sz * a2z
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2

    # reject t <= 0 or t >= tmax, sign-aware without dividing (triangle.cpp:291)
    pos_det = det > 0
    t_ok = torch.where(
        pos_det, (t_scaled > 0) & (t_scaled < tmax * det),
        (t_scaled < 0) & (t_scaled > tmax * det),
    )
    hit = same_sign & (det != 0) & t_ok

    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    t = t_scaled * inv_det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    return hit, t, b0, b1, b2
