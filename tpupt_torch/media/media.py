"""Participating media (counterpart of src/media/ and core/medium.*; the JAX
package's media/media.py).

- homogeneous: Beer-Lambert transmittance and channel-balanced distance
  sampling (media/homogeneous.cpp:44,49);
- grid: trilinear density lookup in an (nz, ny, nx) texel block, ratio
  tracking for transmittance and delta tracking for distance sampling
  (media/grid.cpp:62,90);
- the Henyey-Greenstein phase function (core/medium.cpp).

Every named medium of a scene is stacked into one `MediaTable` (its fields
are DeviceScene's `med_*` tables); each ray lane carries a medium id, -1 for
vacuum. `tr_lane` and `sample_distance_lane` take per-lane ids. Their grid
loops (32 ratio-tracking, 64 delta-tracking steps, each with two hashes, a
log and a trilinear lookup of eight texels) are what the hand-written kernel
of csrc/media_tracking.cu runs on the card (ops/media_tracking.py);
`tr_grid_plain` and `sample_distance_grid_plain` here are its plain versions,
which CPU tensors take and the kernel is held against, operation for
operation: the world-to-medium product is written term by term, and the
per-medium constants (1 / majorant, the mean extinction) are computed on the
table once and gathered, so that both see the same bits.

`build_medium` and the global-medium `grid_density` / `transmittance` /
`sample_distance` serve tools that inspect one medium (`Renderer._medium`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tpupt_torch.core import rng
from tpupt_torch.core.transforms import Transform
from tpupt_torch.core.vecmath import coordinate_system

MEDIUM_HOMOGENEOUS, MEDIUM_GRID = 1, 2

# the fixed step counts of the grid loops (grid.cpp's loops end on their
# own; these bound them) and the hash words of their random numbers
TR_STEPS, DISTANCE_STEPS = 32, 64
TR_WORD, DISTANCE_WORD, REAL_WORD, HOMOGENEOUS_WORD = 7919, 104729, 1299709, 3571
# escaped rays are clamped to this distance
T_CLAMP = 1e7


class MediumParams(NamedTuple):
    """One medium's parameters (numpy, on the host)."""

    kind: int                 # MEDIUM_HOMOGENEOUS or MEDIUM_GRID
    sigma_a: np.ndarray       # (3,) float32
    sigma_s: np.ndarray       # (3,) float32
    g: float                  # HG asymmetry
    density: np.ndarray       # (nz, ny, nx) float32 for grid; (1,1,1) else
    w2m: np.ndarray           # (4,4) float32 world to unit-cube medium space
    sigma_t_max: float        # majorant (delta tracking)


def build_medium(rec, scene=None) -> Optional[MediumParams]:
    """A MediumRecord of scene/api.py -> MediumParams (MakeMedium,
    api.cpp:701-747)."""
    if rec is None:
        return None
    p = rec.params
    sa = p.find_one_spectrum("sigma_a", [1, 1, 1])
    ss = p.find_one_spectrum("sigma_s", [1, 1, 1])
    scale = p.find_one_float("scale", 1.0)
    g = p.find_one_float("g", 0.0)
    sa = np.asarray(sa) * scale
    ss = np.asarray(ss) * scale
    if rec.type in ("heterogeneous", "grid"):
        nx = p.find_one_int("nx", 1)
        ny = p.find_one_int("ny", 1)
        nz = p.find_one_int("nz", 1)
        d = p.find_floats("density")
        if d is None:
            d = np.ones(nx * ny * nz)
        density = np.asarray(d, np.float32).reshape(nz, ny, nx)
        p0 = p.find_one_point("p0", [0, 0, 0])
        p1 = p.find_one_point("p1", [1, 1, 1])
        # medium space: the unit cube over [p0, p1], then medium_to_world
        m2w = rec.medium_to_world * Transform.translate(p0) * Transform.scale(
            np.maximum(np.asarray(p1) - np.asarray(p0), 1e-9))
        sig_t = float((sa + ss).max())
        return MediumParams(
            kind=MEDIUM_GRID, sigma_a=sa.astype(np.float32),
            sigma_s=ss.astype(np.float32), g=g, density=density,
            w2m=m2w.m_inv.astype(np.float32),
            sigma_t_max=sig_t * float(density.max()))
    return MediumParams(
        kind=MEDIUM_HOMOGENEOUS, sigma_a=sa.astype(np.float32),
        sigma_s=ss.astype(np.float32), g=g,
        density=np.ones((1, 1, 1), np.float32),
        w2m=np.eye(4, dtype=np.float32), sigma_t_max=float((sa + ss).max()))


# ----------------------------- phase function -------------------------------


def hg_phase(cos_theta, g):
    """HG phase value (medium.h PhaseHG)."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * math.pi * denom * torch.sqrt(
        torch.clamp_min(denom, 1e-8)))


def hg_sample(axis, u1, u2, g: float):
    """Sample the HG phase around the propagation direction `axis` = -wo
    (medium.cpp Sample_p builds its frame around -wo). Returns (wi, pdf),
    the pdf in the reference's wo-relative convention, PhaseHG(dot(wo, wi))."""
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * u1
    else:
        sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * u1)
        cos_t = (1.0 + g * g - sq * sq) / (2.0 * g)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2
    t, b = coordinate_system(axis)
    wi = ((sin_t * torch.cos(phi))[..., None] * t
          + (sin_t * torch.sin(phi))[..., None] * b + cos_t[..., None] * axis)
    return wi, hg_phase(-cos_t, g)


# ----------------------- one global medium (tools) --------------------------


def _lerp8(v, fx, fy, fz):
    """grid.cpp D() interpolation of the eight corner values v (x fastest,
    then y, z)."""
    d00 = v[0] * (1 - fx) + v[1] * fx
    d10 = v[2] * (1 - fx) + v[3] * fx
    d01 = v[4] * (1 - fx) + v[5] * fx
    d11 = v[6] * (1 - fx) + v[7] * fx
    return ((d00 * (1 - fy) + d10 * fy) * (1 - fz)
            + (d01 * (1 - fy) + d11 * fy) * fz)


def _trilinear(d_at, ix, iy, iz, fx, fy, fz):
    """grid.cpp D() interpolation of the eight texels around a point."""
    return _lerp8([d_at(ix + dx, iy + dy, iz + dz) for dz in (0, 1)
                   for dy in (0, 1) for dx in (0, 1)], fx, fy, fz)


def grid_density(mp: MediumParams, p_world):
    """Trilinear density of one grid medium at points (N,3) (grid.cpp
    Density)."""
    w = torch.as_tensor(mp.w2m, dtype=p_world.dtype, device=p_world.device)
    dens = torch.as_tensor(mp.density, device=p_world.device)
    ph = p_world @ w[:3, :3].T + w[:3, 3]
    nz, ny, nx = mp.density.shape
    g = torch.stack([ph[..., 0] * nx - 0.5, ph[..., 1] * ny - 0.5,
                     ph[..., 2] * nz - 0.5], -1)
    gi = torch.floor(g)
    gf = g - gi

    def d_at(ix, iy, iz):
        inside = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
                  & (iz >= 0) & (iz < nz))
        v = dens[iz.clamp(0, nz - 1).long(), iy.clamp(0, ny - 1).long(),
                 ix.clamp(0, nx - 1).long()]
        return torch.where(inside, v, 0.0)

    gi = gi.to(torch.int32)
    return _trilinear(d_at, gi[..., 0], gi[..., 1], gi[..., 2],
                      gf[..., 0], gf[..., 1], gf[..., 2])


def transmittance(mp: MediumParams, o, d, t_max, u_keys):
    """Tr (N,3) of one medium along [0, t_max]: Beer-Lambert for a
    homogeneous one (homogeneous.cpp:44), ratio tracking for a grid
    (grid.cpp:62)."""
    t_c = t_max.clamp_max(T_CLAMP)
    sigma_t = torch.as_tensor(mp.sigma_a + mp.sigma_s, device=o.device)
    if mp.kind == MEDIUM_HOMOGENEOUS:
        return torch.exp(-sigma_t[None, :] * t_c[..., None])
    inv_max = 1.0 / max(mp.sigma_t_max, 1e-9)
    sig_max = float(np.max(mp.sigma_a + mp.sigma_s))
    tr = o.new_ones(o.shape[0])
    t = o.new_zeros(o.shape[0])
    for k in range(TR_STEPS):
        u = rng.uniform_float(u_keys, k, TR_WORD)
        t = t - torch.log(1.0 - u) * inv_max
        dens = grid_density(mp, o + t[..., None] * d)
        tr = tr * torch.where(t < t_c, 1.0 - torch.clamp_min(
            dens * sig_max * inv_max, 0.0), 1.0)
    return tr[..., None].expand(-1, 3)


def sample_distance(mp: MediumParams, o, d, t_surf, u1, u_keys):
    """A medium interaction before t_surf in one medium: channel-balanced
    exponential (homogeneous.cpp:49) or delta tracking (grid.cpp:90).
    Returns (interacted (N,), t_m (N,), weight (N,3))."""
    sigma_s = torch.as_tensor(mp.sigma_s, device=o.device)
    sigma_t = torch.as_tensor(mp.sigma_a, device=o.device) + sigma_s
    t_c = t_surf.clamp_max(T_CLAMP)
    n = o.shape[0]
    if mp.kind == MEDIUM_HOMOGENEOUS:
        ch = (u1 * 3).to(torch.int32).clamp_max(2)
        s_ch = sigma_t[ch.long()]
        u2 = rng.uniform_float(u_keys, HOMOGENEOUS_WORD)
        t_m = (-torch.log(torch.clamp_min(1.0 - u2, 1e-9))
               / torch.clamp_min(s_ch, 1e-9))
        interacted = t_m < t_c
        tr = torch.exp(-sigma_t[None, :] * torch.minimum(t_m, t_c)[..., None])
        pdf_m = torch.mean(sigma_t[None, :] * tr, -1)
        pdf_s = torch.mean(tr, -1)
        w_m = tr * sigma_s[None, :] / torch.clamp_min(pdf_m, 1e-12)[..., None]
        w_s = tr / torch.clamp_min(pdf_s, 1e-12)[..., None]
        return interacted, t_m, torch.where(interacted[..., None], w_m, w_s)
    inv_max = 1.0 / max(mp.sigma_t_max, 1e-9)
    sig_mean = float(np.mean(mp.sigma_a + mp.sigma_s))
    t = o.new_zeros(n)
    done = torch.zeros(n, dtype=torch.bool, device=o.device)
    interacted = torch.zeros_like(done)
    for k in range(DISTANCE_STEPS):
        u = rng.uniform_float(u_keys, k, DISTANCE_WORD)
        t_new = t - torch.log(1.0 - u) * inv_max
        past = t_new >= t_c
        dens = grid_density(mp, o + t_new[..., None] * d)
        real = rng.uniform_float(u_keys, k, REAL_WORD) < (
            dens * sig_mean * inv_max)
        hit_m = ~done & ~past & real
        interacted = interacted | hit_m
        t = torch.where(done, t, t_new)
        done = done | past | hit_m
    weight = torch.where(interacted[..., None],
                         (sigma_s / torch.clamp_min(sigma_t, 1e-9))[None, :],
                         o.new_ones(n, 3))
    return interacted, t, weight


# --------------------- per-interface media (MediaTable) ---------------------


class MediaTable(NamedTuple):
    """All scene media stacked; a medium id indexes the rows, -1 = vacuum."""

    sigma_a: torch.Tensor    # (M, C): C = 3, or 60 in spectral transport
    sigma_s: torch.Tensor    # (M, C)
    g: torch.Tensor          # (M,)
    majorant: torch.Tensor   # (M,) sigma_t_max * density_max
    is_grid: torch.Tensor    # (M,) bool
    density: torch.Tensor    # flat atlas of every grid's texels (>= 1)
    dens_off: torch.Tensor   # (M,) i32 offset of a medium's texels
    dens_dims: torch.Tensor  # (M, 3) i32 (nx, ny, nz)
    w2m: torch.Tensor        # (M, 4, 4) world -> unit-cube medium space


def build_media_table(scene):
    """FlatScene -> (dict of the `med_*` numpy tables, or None without media;
    any_grid). Rows follow scene.media_order, the ids that flatten baked
    into the prims' med_in / med_out."""
    order = scene.media_order or []
    if not order:
        return None, False
    params = [build_medium(scene.media[name], scene) for name in order]
    offs, dims, chunks, cur = [], [], [], 0
    for p in params:
        offs.append(cur)
        nz, ny, nx = p.density.shape
        dims.append((nx, ny, nz))
        chunks.append(p.density.reshape(-1))
        cur += p.density.size
    return dict(
        med_sigma_a=np.stack([p.sigma_a for p in params]),
        med_sigma_s=np.stack([p.sigma_s for p in params]),
        med_g=np.asarray([p.g for p in params], np.float32),
        med_majorant=np.asarray([p.sigma_t_max for p in params], np.float32),
        med_is_grid=np.asarray([p.kind == MEDIUM_GRID for p in params]),
        med_density=np.concatenate(chunks).astype(np.float32),
        med_dens_off=np.asarray(offs, np.int32),
        med_dens_dims=np.asarray(dims, np.int32),
        med_w2m=np.stack([p.w2m for p in params]),
    ), any(p.kind == MEDIUM_GRID for p in params)


def media_view(ds) -> MediaTable:
    """The stacked media table carried inside a DeviceScene."""
    return MediaTable(
        sigma_a=ds.med_sigma_a, sigma_s=ds.med_sigma_s, g=ds.med_g,
        majorant=ds.med_majorant, is_grid=ds.med_is_grid,
        density=ds.med_density, dens_off=ds.med_dens_off,
        dens_dims=ds.med_dens_dims, w2m=ds.med_w2m)


def tracking_constants(mt: MediaTable):
    """(1 / majorant (M,), mean extinction over the channels (M,)) of each
    medium: the constants of its grid loops, computed once on the table, so
    that the kernel and the plain loops gather the same bits."""
    inv_max = 1.0 / torch.clamp_min(mt.majorant, 1e-9)
    sig_mean = torch.mean(mt.sigma_a + mt.sigma_s, -1)
    return inv_max, sig_mean


def _corners(mt: MediaTable, mi, p):
    """The eight texels of the trilinear lookup (grid.cpp Density) of
    medium mi[n] at the point (p[0][n], p[1][n], p[2][n]): (values [8], 0
    outside the grid; flat atlas indices [8]; inside masks [8]; fractions
    [fx, fy, fz]; the lanes' world-to-medium matrices), corners x fastest,
    then y, z. The world-to-medium product is written term by term, in the
    order the kernel computes it."""
    w = mt.w2m[mi]
    ph = [w[:, r, 0] * p[0] + w[:, r, 1] * p[1] + w[:, r, 2] * p[2]
          + w[:, r, 3] for r in range(3)]
    dims = mt.dens_dims[mi]
    nx, ny, nz = dims[:, 0], dims[:, 1], dims[:, 2]
    off = mt.dens_off[mi]
    g = [ph[0] * nx - 0.5, ph[1] * ny - 0.5, ph[2] * nz - 0.5]
    gi = [torch.floor(x) for x in g]
    frac = [x - xi for x, xi in zip(g, gi)]
    ix, iy, iz = (x.to(torch.int32) for x in gi)
    vals, idxs, ins = [], [], []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                inside = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                          & (jz >= 0) & (jz < nz))
                jx = torch.minimum(jx.clamp_min(0), nx - 1)
                jy = torch.minimum(jy.clamp_min(0), ny - 1)
                jz = torch.minimum(jz.clamp_min(0), nz - 1)
                idx = (off + (jz * ny + jy) * nx + jx).long()
                vals.append(torch.where(inside, mt.density[idx], 0.0))
                idxs.append(idx)
                ins.append(inside)
    return vals, idxs, ins, frac, w


def grid_density_lane(mt: MediaTable, mi, p_world):
    """Per-lane trilinear density from the atlas (grid.cpp Density): lane
    n reads medium mi[n] at p_world[n]."""
    tv, _, _, frac, _ = _corners(mt, mi, [p_world[:, a] for a in range(3)])
    return _lerp8(tv, *frac)


def tr_grid_plain(mt: MediaTable, mi, o, d, t_c, keys):
    """The plain version of the kernel's ratio tracking (grid.cpp:62): the
    grid transmittance (N,) of each lane over [0, t_c] through medium mi,
    TR_STEPS steps. Every lane is computed (the kernel leaves the lanes
    whose result is not used at once)."""
    inv_max_m, sig_mean_m = tracking_constants(mt)
    inv_max, sig_mean = inv_max_m[mi], sig_mean_m[mi]
    zero = t_c.new_zeros(())
    trg = torch.ones_like(t_c)
    t = torch.zeros_like(t_c)
    for k in range(TR_STEPS):
        u = rng.uniform_float(keys, k, TR_WORD)
        t = t - torch.log(1.0 - u) * inv_max
        dens = grid_density_lane(mt, mi, o + t[..., None] * d)
        # torch.maximum, not clamp_min: at x == 0 (an empty texel) its
        # derivative is 1/2, as jnp.maximum's in the JAX package
        trg = trg * torch.where(
            t < t_c, 1.0 - torch.maximum(dens * sig_mean * inv_max, zero),
            1.0)
    return trg


# the per-lane outputs of ratio tracking's backward, by column of (N, 20):
# the origin's and the direction's gradients, those of the lane's
# 1 / majorant and mean extinction, and of the first three rows of its
# world-to-medium matrix (row-major, 4 a row)
TR_BWD_O, TR_BWD_D, TR_BWD_INV, TR_BWD_SIG, TR_BWD_W2M = 0, 3, 6, 7, 8
TR_BWD_COLS = 20


def tr_grid_backward_plain(mt: MediaTable, mi, o, d, t_c, keys, g_trg,
                           live=None):
    """The plain version of K6's ratio-tracking backward: the adjoint of
    `tr_grid_plain` for the cotangent g_trg (N,) of its transmittance,
    written out step by step (not autograd), in the order the kernel
    computes it. Returns (g_lane (N, TR_BWD_COLS), g_density (T,)): per
    lane the gradients with respect to o, d, the lane's 1 / majorant and
    mean extinction and its world-to-medium rows (columns TR_BWD_*), and
    the density atlas's gradient, summed over the lanes. Lanes outside
    `live` (N,) bool get zeros (the kernel does not compute them).

    With x_k = dens_k * sig_mean * inv_max at the step's point p_k = o +
    t_k d (t_k = inv_max * S_k, S_k the sum of the first k exponential
    draws) and the factor f_k = 1 - max(x_k, 0) of each step before t_c,
    the transmittance is the product of the f_k. The cotangent of f_k is
    g_trg times the product of the other factors, taken as the product of
    the factors before k (the transmittance before the step, kept from the
    forward walk) times that of the factors after k (accumulated into the
    cotangent walking back); never as trg / f_k, since a factor is exactly
    0 wherever x_k >= 1. max's derivative is 1/2 at x == 0 (jnp.maximum's
    rule); floor's is 0, and a texel outside the grid gets nothing."""
    inv_max_m, sig_mean_m = tracking_constants(mt)
    inv_max, sig_mean = inv_max_m[mi], sig_mean_m[mi]
    zero = t_c.new_zeros(())
    g = g_trg if live is None else torch.where(live, g_trg, zero)
    # the forward walk: each step's t, sum of draws, and the transmittance
    # before it
    ts, ss, ps, acts = [], [], [], []
    trg = torch.ones_like(t_c)
    t = torch.zeros_like(t_c)
    s = torch.zeros_like(t_c)
    for k in range(TR_STEPS):
        u = rng.uniform_float(keys, k, TR_WORD)
        lg = torch.log(1.0 - u)
        t = t - lg * inv_max
        s = s - lg
        act = t < t_c
        dens = grid_density_lane(mt, mi, o + t[..., None] * d)
        f = 1.0 - torch.maximum(dens * sig_mean * inv_max, zero)
        ts.append(t)
        ss.append(s)
        ps.append(trg)
        acts.append(act)
        trg = torch.where(act, trg * f, trg)
    # the walk back
    c = g
    acc_o = [torch.zeros_like(t_c) for _ in range(3)]
    acc_d = [torch.zeros_like(t_c) for _ in range(3)]
    acc_w = [torch.zeros_like(t_c) for _ in range(12)]
    acc_inv = torch.zeros_like(t_c)
    acc_sig = torch.zeros_like(t_c)
    g_dens = torch.zeros_like(mt.density)
    dims = mt.dens_dims[mi]
    for k in reversed(range(TR_STEPS)):
        t, act = ts[k], acts[k]
        p = [o[:, a] + t * d[:, a] for a in range(3)]
        tv, idx, ins, (fx, fy, fz), w = _corners(mt, mi, p)
        ex, ey, ez = 1.0 - fx, 1.0 - fy, 1.0 - fz
        d00 = tv[0] * ex + tv[1] * fx
        d10 = tv[2] * ex + tv[3] * fx
        d01 = tv[4] * ex + tv[5] * fx
        d11 = tv[6] * ex + tv[7] * fx
        lo = d00 * ey + d10 * fy
        hi = d01 * ey + d11 * fy
        dens = lo * ez + hi * fz
        a = dens * sig_mean
        x = a * inv_max
        f = 1.0 - torch.maximum(x, zero)
        gf = c * ps[k]
        c = torch.where(act, c * f, c)
        m = torch.where(x > 0.0, 1.0, torch.where(x == 0.0, 0.5, 0.0))
        gx = -(gf * m)
        acc_inv = torch.where(act, acc_inv + gx * a, acc_inv)
        ga = gx * inv_max
        acc_sig = torch.where(act, acc_sig + ga * dens, acc_sig)
        gdn = ga * sig_mean
        glo = gdn * ez
        ghi = gdn * fz
        gfz = gdn * (hi - lo)
        gd = [glo * ey, glo * fy, ghi * ey, ghi * fy]
        gfy = glo * (d10 - d00) + ghi * (d11 - d01)
        gfx = (gd[0] * (tv[1] - tv[0]) + gd[1] * (tv[3] - tv[2])
               + gd[2] * (tv[5] - tv[4]) + gd[3] * (tv[7] - tv[6]))
        for j in range(8):
            gt = gd[j // 2] * (fx if j % 2 else ex)
            keep = act & ins[j] if live is None else act & ins[j] & live
            g_dens.index_add_(0, idx[j], torch.where(keep, gt, zero))
        gph = [gfx * dims[:, 0], gfy * dims[:, 1], gfz * dims[:, 2]]
        for r in range(3):
            for col in range(3):
                acc_w[4 * r + col] = torch.where(
                    act, acc_w[4 * r + col] + gph[r] * p[col],
                    acc_w[4 * r + col])
            acc_w[4 * r + 3] = torch.where(act, acc_w[4 * r + 3] + gph[r],
                                           acc_w[4 * r + 3])
        gp = [gph[0] * w[:, 0, col] + gph[1] * w[:, 1, col]
              + gph[2] * w[:, 2, col] for col in range(3)]
        for col in range(3):
            acc_o[col] = torch.where(act, acc_o[col] + gp[col], acc_o[col])
            acc_d[col] = torch.where(act, acc_d[col] + gp[col] * t,
                                     acc_d[col])
        gt_k = gp[0] * d[:, 0] + gp[1] * d[:, 1] + gp[2] * d[:, 2]
        acc_inv = torch.where(act, acc_inv + gt_k * ss[k], acc_inv)
    g_lane = torch.stack(acc_o + acc_d + [acc_inv, acc_sig] + acc_w, -1)
    if live is not None:
        g_lane = torch.where(live[:, None], g_lane, zero)
    return g_lane, g_dens


def sample_distance_grid_plain(mt: MediaTable, mi, o, d, t_c, keys):
    """The plain version of the kernel's delta tracking (grid.cpp:90):
    (interacted (N,) bool, t (N,)) of each lane through medium mi before
    t_c, DISTANCE_STEPS steps. Every lane is computed, as in
    `tr_grid_plain`."""
    inv_max_m, sig_mean_m = tracking_constants(mt)
    inv_max, sig_mean = inv_max_m[mi], sig_mean_m[mi]
    t = torch.zeros_like(t_c)
    done = torch.zeros(t_c.shape, dtype=torch.bool, device=t_c.device)
    interacted = torch.zeros_like(done)
    for k in range(DISTANCE_STEPS):
        u = rng.uniform_float(keys, k, DISTANCE_WORD)
        t_new = t - torch.log(1.0 - u) * inv_max
        past = t_new >= t_c
        dens = grid_density_lane(mt, mi, o + t_new[..., None] * d)
        real = rng.uniform_float(keys, k, REAL_WORD) < (
            dens * sig_mean * inv_max)
        hit_m = ~done & ~past & real
        interacted = interacted | hit_m
        t = torch.where(done, t, t_new)
        done = done | past | hit_m
    return interacted, t


def _kernel():
    """K6's wrappers (imported here: ops/media_tracking.py imports this
    module)."""
    from tpupt_torch.ops import media_tracking

    return media_tracking


def _max(x, c: float):
    """max(x, c) with jnp.maximum's derivative (1/2 to each side at a tie;
    clamp_min gives x all of it)."""
    return torch.maximum(x, x.new_tensor(c))


def _t_clamped(t):
    return torch.minimum(t, t.new_tensor(T_CLAMP))


def tr_lane(mt: MediaTable, any_grid: bool, med, o, d, t_max, u_keys):
    """Per-lane transmittance (N, C) for medium ids med (N,) (-1 = vacuum:
    1): Beer-Lambert in a homogeneous medium, ratio tracking over the atlas
    in a grid one (its scalar repeated over the channels; K6's `tr_grid`,
    which runs `tr_grid_plain` for CPU tensors). Differentiable with
    respect to o, d and every float table of `mt`, as jax.grad of the JAX
    package's tr_lane: the grid lanes through K6's backward (ops/
    media_tracking.py `TrGrid`)."""
    mi = med.clamp_min(0).long()
    sigma_t = mt.sigma_a[mi] + mt.sigma_s[mi]
    t_c = _t_clamped(t_max)
    tr = torch.exp(-sigma_t * t_c[..., None])
    if any_grid:
        grid = mt.is_grid[mi] & (med >= 0)
        trg = _kernel().tr_grid(mt, mi, o, d, t_c, u_keys, grid)
        tr = torch.where(grid[..., None], trg[..., None].expand_as(tr), tr)
    return torch.where((med >= 0)[..., None], tr, 1.0)


def sample_distance_lane(mt: MediaTable, any_grid: bool, med, o, d, t_surf,
                         u1, u_keys):
    """Per-lane medium-interaction sampling against medium ids med (N,);
    vacuum lanes never interact. Returns (interacted (N,), t_m (N,),
    weight (N, C)). Grid lanes take K6's `sample_distance_grid` (its plain
    version for CPU tensors); t_m of a vacuum lane is its medium-0
    homogeneous draw (unused). Differentiable as jax.grad of the JAX
    package's sample_distance_lane: the homogeneous t_m, pdfs and weights
    with respect to the sigma tables, a grid lane's t with respect to its
    majorant (`SampleDistanceGrid`), its weight to the sigma tables."""
    mi = med.clamp_min(0).long()
    sigma_s = mt.sigma_s[mi]
    sigma_t = mt.sigma_a[mi] + sigma_s
    nch = sigma_t.shape[-1]
    t_c = _t_clamped(t_surf)

    # homogeneous: channel-balanced exponential (homogeneous.cpp:49-77)
    ch = (u1 * nch).to(torch.int32).clamp_max(nch - 1)
    s_ch = sigma_t.gather(1, ch.long()[:, None])[:, 0]
    u2 = rng.uniform_float(u_keys, HOMOGENEOUS_WORD)
    t_m = -torch.log(_max(1.0 - u2, 1e-9)) / _max(s_ch, 1e-9)
    interacted = t_m < t_c
    tr = torch.exp(-sigma_t * torch.minimum(t_m, t_c)[..., None])
    pdf_m = torch.mean(sigma_t * tr, -1)
    pdf_s = torch.mean(tr, -1)
    w_m = tr * sigma_s / _max(pdf_m, 1e-12)[..., None]
    w_s = tr / _max(pdf_s, 1e-12)[..., None]
    weight = torch.where(interacted[..., None], w_m, w_s)

    if any_grid:
        grid = mt.is_grid[mi] & (med >= 0)
        inter_g, t_g = _kernel().sample_distance_grid(mt, mi, o, d, t_c,
                                                      u_keys, grid)
        w_g = torch.where(inter_g[..., None],
                          sigma_s / _max(sigma_t, 1e-9), 1.0)
        interacted = torch.where(grid, inter_g, interacted)
        t_m = torch.where(grid, t_g, t_m)
        weight = torch.where(grid[..., None], w_g, weight)

    vac = med < 0
    return (interacted & ~vac, t_m,
            torch.where(vac[..., None], 1.0, weight))
