"""Scatter-add film with reconstruction filters and AOV telemetry.

Counterpart of src/core/film.{h,cpp}: the reference accumulates
filter-weighted samples into tile-private buffers merged under a mutex
(film.cpp:118); here the film is a flat (H*W, C) tensor and every sample adds
into its filter footprint with `index_add`. Thesis per-pixel GeneralStats
(film.h:86-91, WriteGeneralStats film.cpp:170-240) map to extra AOV channels
accumulated by the same scatter.

Masked and out-of-range lanes are dropped properly: they add weight zero at a
clamped index. (The JAX package's single-tap path marks them with index -1,
which wraps to the last pixel; parity tests leave the bottom-right pixel out
whenever a batch has such lanes.)

Filters (src/filters/): box, triangle, gaussian, mitchell, windowed sinc,
evaluated over the static (2R)^2 footprint taps. `index_add` on a CUDA
tensor sums with atomics, so the order of additions into one pixel, and with
it the last bits of a multi-tap film, can change from run to run.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpupt_torch.scene.flatten import (FILTER_BOX, FILTER_GAUSSIAN,
                                       FILTER_MITCHELL, FILTER_SINC,
                                       FILTER_TRIANGLE, FilmConfig)


class Film(NamedTuple):
    """rgb: weighted sums; weight: filter-weight sums; splat: unweighted
    splats (BDPT's t == 1 strategies, MLT); aov: (H*W, A) telemetry
    sums."""

    rgb: torch.Tensor     # (H*W, 3)
    weight: torch.Tensor  # (H*W,)
    splat: torch.Tensor   # (H*W, 3)
    aov: torch.Tensor     # (H*W, n_aov)


N_AOV = 4  # node visits, leaf visits, prim tests, path length


def new_film(xres: int, yres: int, device="cuda") -> Film:
    n = xres * yres
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return Film(rgb=z(n, 3), weight=z(n), splat=z(n, 3), aov=z(n, N_AOV))


def filter_eval(ftype: int, params: Tuple[float, ...], radius: Tuple[float, float],
                dx, dy):
    """Evaluate the reconstruction filter at offsets (dx, dy) from the sample.
    ftype/params/radius are static."""
    rx, ry = radius
    ax, ay = torch.abs(dx), torch.abs(dy)
    inside = (ax <= rx) & (ay <= ry)
    if ftype == FILTER_BOX:
        w = torch.ones_like(dx)
    elif ftype == FILTER_TRIANGLE:
        w = (rx - ax).clamp_min(0.0) * (ry - ay).clamp_min(0.0)
    elif ftype == FILTER_GAUSSIAN:
        alpha = params[0] if params else 2.0
        expx = float(np.exp(-alpha * rx * rx))
        expy = float(np.exp(-alpha * ry * ry))
        gx = (torch.exp(-alpha * dx * dx) - expx).clamp_min(0.0)
        gy = (torch.exp(-alpha * dy * dy) - expy).clamp_min(0.0)
        w = gx * gy
    elif ftype == FILTER_MITCHELL:
        B, C = params if params else (1.0 / 3.0, 1.0 / 3.0)

        def m1d(x):
            x = torch.abs(2.0 * x)
            x2, x3 = x * x, x * x * x
            return torch.where(
                x > 1.0,
                ((-B - 6 * C) * x3 + (6 * B + 30 * C) * x2
                 + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) * (1.0 / 6.0),
                ((12 - 9 * B - 6 * C) * x3 + (-18 + 12 * B + 6 * C) * x2
                 + (6 - 2 * B)) * (1.0 / 6.0),
            ) * (x < 2.0)

        w = m1d(dx / rx) * m1d(dy / ry)
    elif ftype == FILTER_SINC:
        tau = params[0] if params else 3.0

        def sinc(x):
            x = torch.abs(x) + 1e-8
            return torch.sin(math.pi * x) / (math.pi * x)

        def windowed(x, r):
            return torch.where(torch.abs(x) > r, 0.0, sinc(x) * sinc(x / tau))

        w = windowed(dx, rx) * windowed(dy, ry)
    else:
        w = torch.ones_like(dx)
    return torch.where(inside, w, 0.0)


def add_samples(film: Film, cfg: FilmConfig, p_film, L, aov=None,
                mask=None) -> Film:
    """FilmTile::AddSample counterpart (film.h:130): p_film (N,2) continuous
    raster coords; L (N,3). Adds into the filter footprint. `mask` (N,)
    bool drops padded lanes (fixed-size wavefront batches)."""
    xres, yres = cfg.xres, cfg.yres
    rx, ry = cfg.filter_radius
    # discrete taps covering the footprint
    nx = max(1, int(np.ceil(2.0 * rx - 0.5)) + 1) if rx > 0.5 else 1
    ny = max(1, int(np.ceil(2.0 * ry - 0.5)) + 1) if ry > 0.5 else 1

    # continuous -> discrete (pbrt: d = floor(c - 0.5) ... )
    dpx = p_film[:, 0] - 0.5
    dpy = p_film[:, 1] - 0.5
    x0 = torch.ceil(dpx - rx)
    y0 = torch.ceil(dpy - ry)

    rgb, wsum, aov_acc = film.rgb, film.weight, film.aov
    for jx in range(nx):
        for jy in range(ny):
            px = x0 + jx
            py = y0 + jy
            w = filter_eval(cfg.filter_type, cfg.filter_params,
                            cfg.filter_radius, px - dpx, py - dpy)
            ix = px.to(torch.int64)
            iy = py.to(torch.int64)
            valid = (ix >= 0) & (ix < xres) & (iy >= 0) & (iy < yres)
            if mask is not None:
                valid = valid & mask
            w = torch.where(valid, w, 0.0)
            pid = iy.clamp(0, yres - 1) * xres + ix.clamp(0, xres - 1)
            rgb = rgb.index_add(0, pid, w[:, None] * L)
            wsum = wsum.index_add(0, pid, w)
            if aov is not None:
                aov_acc = aov_acc.index_add(0, pid, w[:, None] * aov)
    return Film(rgb=rgb, weight=wsum, splat=film.splat, aov=aov_acc)


def add_splats(film: Film, cfg: FilmConfig, p_film, L) -> Film:
    """Film::AddSplat counterpart (film.cpp:144): unweighted accumulation
    into the pixel under each raster position, clamped to the film (a
    lane that splats nothing carries L = 0)."""
    ix = p_film[:, 0].to(torch.int32).clamp(0, cfg.xres - 1)
    iy = p_film[:, 1].to(torch.int32).clamp(0, cfg.yres - 1)
    pid = (iy * cfg.xres + ix).long()
    return film._replace(splat=film.splat.index_add(0, pid, L))


def to_image(film: Film, cfg: FilmConfig, splat_scale: float = 0.0):
    """Film::WriteImage normalization: rgb/weight + splatScale*splat."""
    w = film.weight.clamp_min(1e-10)[:, None]
    img = film.rgb / w
    if splat_scale:
        img = img + splat_scale * film.splat
    img = img * cfg.scale
    return img.reshape(cfg.yres, cfg.xres, 3)


def aov_images(film: Film, cfg: FilmConfig):
    """Per-pixel telemetry maps (WriteGeneralStats parity): returns dict of
    (H, W) arrays averaged per sample weight."""
    w = film.weight.clamp_min(1e-10)[:, None]
    maps = film.aov / w
    names = ["node_visits", "leaf_visits", "prim_tests", "path_length"]
    return {nm: maps[:, i].reshape(cfg.yres, cfg.xres)
            for i, nm in enumerate(names)}
