"""Realistic (lens-system) camera: counterpart of cameras/realistic.cpp.

Each camera ray is traced through a stack of spherical lens elements read
from a lens description file (rows: curvature radius, thickness, ior,
aperture diameter; in mm, scaled to meters), with paraxial thick-lens
focusing and exit-pupil sampling (realistic.cpp:36-280). The whole batch is
traced through the stack together: the loop over the elements is a Python
loop over a handful of rows, every lane refracts at once, and vignetted
lanes come back dead (`alive` False), which is the physical cat's-eye
vignetting.

The lens file, the paraxial system matrix, the focusing and the element
positions are numpy on the host, array-equal to the JAX package's;
`trace_lenses_from_film` and `realistic_rays` are plain PyTorch on the
rays' device (no TPU kernel exists for either: the work is elementwise over
a few elements). `bound_exit_pupil` traces its candidate rays on the CPU
once per renderer.

Lens space: film plane at z = 0, scene toward -z; element vertex positions
accumulate rear to front. Rays leaving the front are flipped into camera
space (+z toward the scene), like TraceLensesFromFilm's z-negation
(realistic.cpp:182-229).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpupt_torch.core.sampling import concentric_sample_disk


def load_lens_file(path: str) -> np.ndarray:
    """Rows: curvature radius, thickness, eta, aperture diameter (mm);
    returns (E,4) in meters, the diameter halved to a radius
    (realistic.cpp:42-55)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) >= 4:
                rows.append(vals[:4])
    lens = np.asarray(rows, np.float64)
    lens[:, 0] *= 1e-3  # radius
    lens[:, 1] *= 1e-3  # thickness
    lens[:, 3] *= 1e-3 * 0.5  # aperture diameter -> radius
    return lens


def _paraxial_system_matrix(lens):
    """2x2 ray-transfer matrix of the stack, front to rear (scene -> film)."""
    m = np.eye(2)
    n_prev = 1.0
    for i in range(len(lens)):
        r, t, eta, _ = lens[i]
        n_next = eta if eta != 0 else 1.0
        if r != 0:
            power = (n_next - n_prev) / r
            m = np.array([[1.0, 0.0], [-power, 1.0]]) @ m
        m = np.array([[1.0, t], [0.0, 1.0]]) @ m
        n_prev = n_next
    return m


def focus_thick_lens(lens, focus_distance):
    """The stack with its rear gap (last thickness) set so that objects at
    `focus_distance` image onto the film (FocusThickLens,
    realistic.cpp:258-280), found by bisection on the paraxial transfer
    matrix instead of traced cardinal points. A distance the gap cannot
    focus keeps the file's gap."""
    lens = lens.copy()
    base = lens[-1, 1]

    def film_blur(gap):
        lens[-1, 1] = gap
        # an on-axis object point at the focus distance in front of the
        # front vertex: height at the film = full[0, 1] * slope, want 0
        m = _paraxial_system_matrix(lens)
        full = m @ np.array([[1.0, focus_distance], [0.0, 1.0]])
        return full[0, 1]

    lo, hi = base * 0.2, base * 5.0 + 0.1
    flo, fhi = film_blur(lo), film_blur(hi)
    if flo * fhi > 0:
        lens[-1, 1] = base
        return lens
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        fm = film_blur(mid)
        if flo * fm <= 0:
            hi = mid
        else:
            lo, flo = mid, fm
    lens[-1, 1] = 0.5 * (lo + hi)
    return lens


def element_z_positions(lens):
    """Vertex z of each interface in lens space (film at 0, scene at -z):
    z_i = -(sum of the thicknesses from the interface to the film)."""
    z = np.zeros(len(lens))
    acc = 0.0
    for i in range(len(lens) - 1, -1, -1):
        acc += lens[i, 1]
        z[i] = -acc
    return z


def _dot(a, b):
    return torch.sum(a * b, -1)


def trace_lenses_from_film(lens, zpos, o, d):
    """Batched TraceLensesFromFilm (realistic.cpp:182-229): rays o, d (N,3)
    in lens space from the film through the stack, rear element first.
    Returns (o, d, alive) where the rays leave the front element."""
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    for i in range(len(lens) - 1, -1, -1):
        r, eta, ap = float(lens[i, 0]), float(lens[i, 2]), float(lens[i, 3])
        # a row's eta is the IOR of the medium on the FILM side of interface
        # i (realistic.cpp:201-205): from the film we cross from i's medium
        # into i-1's
        eta_i = eta if eta != 0 else 1.0
        eta_t = (float(lens[i - 1, 2])
                 if i > 0 and lens[i - 1, 2] != 0 else 1.0)
        z_e = float(zpos[i])
        if r == 0.0:
            # aperture stop: plane intersection
            dz = d[:, 2]
            t = (z_e - o[:, 2]) / torch.where(dz.abs() < 1e-12, 1e-12, dz)
            p = o + t[:, None] * d
            alive = alive & (t > 0) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap * ap)
            o = p
            continue
        # spherical interface: its center on the axis at z_e + r
        zc = z_e + r
        center = o.new_tensor([0.0, 0.0, zc])
        oc = o - center
        b = _dot(oc, d)
        c = _dot(oc, oc) - r * r
        disc = b * b - c
        ok = disc >= 0
        sq = torch.sqrt(disc.clamp_min(0.0))
        # the sheet nearest the interface VERTEX (the physical lens surface;
        # IntersectSphericalElement's closer / farther choice,
        # realistic.cpp:158-170, said independently of the side)
        t1 = -b - sq
        t2 = -b + sq
        z1 = torch.abs(o[:, 2] + t1 * d[:, 2] - z_e)
        z2 = torch.abs(o[:, 2] + t2 * d[:, 2] - z_e)
        pick1 = (z1 <= z2) & (t1 > 1e-9) | (t2 <= 1e-9)
        t = torch.where(pick1, t1, t2)
        p = o + t[:, None] * d
        alive = alive & ok & (t > 0) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap * ap)
        nrm = (p - center) / r
        # orient against the incoming direction
        nrm = torch.where((_dot(nrm, d) > 0)[:, None], -nrm, nrm)
        ratio = eta_i / eta_t
        cos_i = -_dot(nrm, d)
        sin2_t = ratio * ratio * (1.0 - cos_i * cos_i).clamp_min(0.0)
        tir = sin2_t >= 1.0
        cos_t = torch.sqrt((1.0 - sin2_t).clamp_min(0.0))
        d_new = ratio * d + (ratio * cos_i - cos_t)[:, None] * nrm
        d_len = torch.sqrt(_dot(d_new, d_new).clamp_min(1e-20))
        d = torch.where(tir[:, None], d, d_new / d_len[:, None])
        alive = alive & ~tir
        o = p
    return o, d, alive


def bound_exit_pupil(lens, zpos, film_diag, n_bins: int = 64,
                     n_side: int = 64) -> np.ndarray:
    """Exit-pupil bounding boxes on the rear element's plane by film radius
    (BoundExitPupil, realistic.cpp:231-256): for each of `n_bins` radial
    segments, a grid of candidate rays from four film points of the segment
    to a square of 1.5x the rear radius is traced, and the (x, y) of those
    that pass the whole stack are bounded. Returns (n_bins, 4) float32
    [x0, y0, x1, y1] in meters, grown by the grid spacing; a bin where no ray
    passes gets the whole rear square. The rays are traced in float32 on the
    CPU."""
    rear_r = float(lens[-1, 3])
    rear_z = float(zpos[-1])
    r_max = film_diag / 2.0
    half = 1.5 * rear_r
    side = np.linspace(-half, half, n_side)
    gx, gy = np.meshgrid(side, side, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    m = gx.size
    out = np.zeros((n_bins, 4), np.float32)
    spacing = 2.0 * half / (n_side - 1)
    pr = torch.from_numpy(
        np.stack([gx, gy, np.full(m, rear_z)], -1).astype(np.float32))
    for b in range(n_bins):
        # four film x positions inside the segment (pbrt samples the
        # segment; four fixed offsets cover it)
        boxes = []
        for fr in (0.125, 0.375, 0.625, 0.875):
            fx = (b + fr) / n_bins * r_max
            o = torch.from_numpy(np.stack(
                [np.full(m, fx), np.zeros(m), np.zeros(m)], -1).astype(
                    np.float32))
            d = pr - o
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            _, _, alive = trace_lenses_from_film(lens, zpos, o, d)
            a = alive.numpy()
            if a.any():
                boxes.append((gx[a].min(), gy[a].min(),
                              gx[a].max(), gy[a].max()))
        if boxes:
            bb = np.array(boxes)
            out[b] = [bb[:, 0].min() - spacing, bb[:, 1].min() - spacing,
                      bb[:, 2].max() + spacing, bb[:, 3].max() + spacing]
        else:
            out[b] = [-half, -half, half, half]
    return out


def realistic_rays(lens, zpos, cam_to_world, p_raster, u_lens, xres, yres,
                   film_diag, pupil=None):
    """World-space rays through the lens stack: p_raster (N,2), u_lens
    (N,2). With `pupil` (the (B,4) boxes of `bound_exit_pupil`, on the rays'
    device), lens samples land in the film point's exit-pupil box rotated to
    its azimuth (SampleExitPupil, realistic.cpp:261-272), and the weight is
    the box's area over the rear disk's, which keeps the estimator's
    normalisation to the rear disk; without it, samples cover the whole rear
    disk with weight 1. Returns (o, d, alive, weight), each (N,...);
    vignetted lanes have alive False."""
    n = p_raster.shape[0]
    aspect = xres / yres
    film_h = film_diag / math.sqrt(1.0 + aspect * aspect)
    film_w = aspect * film_h
    # raster -> physical film point (x right, y up, flipped like the
    # reference's film-to-camera orientation)
    fx = (0.5 - p_raster[:, 0] / xres) * film_w
    fy = (p_raster[:, 1] / yres - 0.5) * film_h
    o_f = torch.stack([fx, fy, torch.zeros_like(fx)], -1)
    rear_r = float(lens[-1, 3])
    rear_z = float(zpos[-1])
    if pupil is not None:
        n_bins = pupil.shape[0]
        r_max = film_diag / 2.0
        r_film = torch.sqrt(fx * fx + fy * fy)
        bin_ = (r_film / r_max * n_bins).to(torch.int32).clamp(0, n_bins - 1)
        box = pupil[bin_.long()]
        px_ = box[:, 0] + u_lens[:, 0] * (box[:, 2] - box[:, 0])
        py_ = box[:, 1] + u_lens[:, 1] * (box[:, 3] - box[:, 1])
        # rotate the canonical (+x film) pupil to the film point's azimuth
        inv_r = 1.0 / r_film.clamp_min(1e-12)
        cs = torch.where(r_film > 1e-9, fx * inv_r, 1.0)
        sn = torch.where(r_film > 1e-9, fy * inv_r, 0.0)
        lx = cs * px_ - sn * py_
        ly = sn * px_ + cs * py_
        area = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
        weight = area / (np.pi * rear_r * rear_r)
    else:
        cx, cy = concentric_sample_disk(u_lens[:, 0], u_lens[:, 1])
        lx, ly = cx * rear_r, cy * rear_r
        weight = p_raster.new_ones(n)
    p_rear = torch.stack([lx, ly, torch.full_like(lx, rear_z)], -1)
    d0 = p_rear - o_f
    d0 = d0 / torch.sqrt(_dot(d0, d0).clamp_min(1e-20))[:, None]
    o_l, d_l, alive = trace_lenses_from_film(lens, zpos, o_f, d0)
    # lens space (scene at -z) -> camera space (scene at +z)
    flip = o_l.new_tensor([1.0, 1.0, -1.0])
    o_c, d_c = o_l * flip, d_l * flip
    m = cam_to_world
    o_w = o_c @ m[:3, :3].T + m[:3, 3]
    d_w = d_c @ m[:3, :3].T
    d_w = d_w / torch.sqrt(_dot(d_w, d_w).clamp_min(1e-20))[:, None]
    return o_w, d_w, alive, weight
