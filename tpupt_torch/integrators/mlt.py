"""Metropolis light transport: multiplexed PSSMLT over BDPT strategies
(counterpart of integrators/mlt.cpp; the JAX package's integrators/mlt.py).

The reference runs PSSMLT over BDPT path strategies: bootstrap paths per
depth estimate the normalisation b (mlt.cpp:177-186), Markov chains mutate
a primary-sample vector with large and small steps (MLTSampler,
mlt.cpp:62-130) and splat both the current and the proposed path with the
Veach-style acceptance weights (mlt.cpp:231-258). Each chain carries a
fixed path depth and picks one (s, t) BDPT strategy per mutation from the
mutated sample (mlt.cpp:151-163, the "multiplexed" MLT of Hachisuka et al.
2014), scaled by nStrategies for the uniform strategy choice.

Here thousands of chains run in lockstep as one wavefront: each lane is a
chain whose state is its primary-sample vector u in [0,1)^D, its fixed
depth, its current radiance and raster position. Each mutation step
evaluates `bdpt_li` once in single-strategy mode, through the renderer's
traversal (K1, K2 or K3 on the card)."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.core import rng
from tpupt_torch.core.rng import M32
from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators.bdpt import bdpt_li


class PSSSampler:
    """Sampler adapter: dimension lookups come from the chain's primary
    sample vector (MLTSampler::Get1D, mlt.cpp:84). BDPT requests dims at
    sparse static offsets (its camera, light and connection streams); each
    distinct offset takes the next free column in request order, so every
    decision in the path gets its own mutated coordinate (the reference's
    three-stream layout, mlt.cpp:62-80, flattened).

    A request past the last column raises: the JAX package wraps it onto
    an earlier column with `%`, which would make two decisions share one
    coordinate. `n_pss_dims` sizes the matrix for every dimension BDPT
    requests, so neither happens at any depth."""

    RESERVED = 5  # 0,1 raster; 2,3 lens; 4 strategy choice

    def __init__(self, u_mat):
        self.u = u_mat  # (N, D)
        self.spp = 1
        self.map = {}

    def dim(self, px, py, s, d):
        col = self.map.setdefault(int(d), self.RESERVED + len(self.map))
        assert col < self.u.shape[1], (
            f"PSS dimension {d} needs column {col} of {self.u.shape[1]}")
        return self.u[:, col]

    def camera_jitter(self, px, py, s):
        return self.u[:, 0], self.u[:, 1]


def n_pss_dims(max_depth: int) -> int:
    """Columns needed for one full BDPT evaluation at max_depth: reserved
    raster / lens / strategy + camera walk + light start + light walk +
    connection streams (bdpt_li's dimension layout)."""
    t_max, s_max = max_depth + 2, max_depth + 1
    return (PSSSampler.RESERVED + 3 * (t_max - 1) + 5 + 3 * (s_max - 1)
            + 3 * (t_max + 2))


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _erfinv(x):
    """Winitzki's approximation (enough for the mutation kernel)."""
    a = 0.147
    x = x.clamp(-0.999999, 0.999999)
    ln1mx2 = torch.log((1.0 - x * x).clamp_min(1e-30))
    t = 2.0 / (math.pi * a) + ln1mx2 / 2.0
    return torch.sign(x) * torch.sqrt(
        (torch.sqrt(t * t - ln1mx2 / a) - t).clamp_min(0.0))


def mutate(u, key, p_large, sigma):
    """Large-step restart or small-step Gaussian perturbation with
    wraparound (MLTSampler::EnsureReady, mlt.cpp:98-126). `key` is a
    32-bit int. Returns (proposal, large-step mask)."""
    n, d = u.shape
    lanes = torch.arange(n, dtype=torch.int64, device=u.device)
    r_large = rng.uniform_float(key, lanes, 0)
    large = r_large < p_large
    dims = torch.arange(d, dtype=torch.int64, device=u.device)
    r = rng.uniform_float((key + 1) & M32, lanes[:, None], dims[None, :])
    r2 = rng.uniform_float((key + 2) & M32, lanes[:, None], dims[None, :])
    small = u + sigma * 1.41421356 * _erfinv(2.0 * r2 - 1.0)
    small = small - torch.floor(small)
    return torch.where(large[:, None], r, small), large


def _splat(splat, p_raster, L, xres, yres):
    ix = p_raster[:, 0].to(torch.int32).clamp(0, xres - 1)
    iy = p_raster[:, 1].to(torch.int32).clamp(0, yres - 1)
    return splat.index_add(0, (iy * xres + ix).long(), L)


class MLTRenderer:
    """MLTIntegrator::Render counterpart (mlt.cpp:165-258) over a
    `Renderer` (its tables, device, batch and traversal wrapper, read at
    every call)."""

    def __init__(self, renderer, n_bootstrap=4096 * 16, n_chains=None,
                 p_large=0.3, sigma=0.01):
        self.r = renderer
        self.p_large = p_large
        self.sigma = sigma
        sc = renderer.scene
        self.xres, self.yres = sc.film.xres, sc.film.yres
        md = sc.integrator.max_depth
        self.max_depth = md
        self.n_dims = n_pss_dims(md)
        self.n = n_chains or renderer.batch
        self.n_bootstrap = max(n_bootstrap // (md + 1), self.n)
        self.b = None
        self.film = None
        self.seconds = None

    @torch.no_grad()
    def eval_path(self, u, depth):
        """L(u | depth): the radiance of the single BDPT strategy the
        sample selects at this chain's depth (mlt.cpp:151-163). Returns
        (L (N,3), p_raster (N,2)): the raster is the lens projection for
        t == 1."""
        r = self.r
        cam = r.scene.camera
        ds = r.ds
        s = PSSSampler(u)
        p_raster = torch.stack([u[:, 0] * self.xres, u[:, 1] * self.yres], -1)
        o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                             p_raster, u[:, 2:4], cam.lens_radius,
                             cam.focal_distance, self.xres, self.yres)
        px = p_raster[:, 0].to(torch.int32).clamp(0, self.xres - 1)
        py = p_raster[:, 1].to(torch.int32).clamp(0, self.yres - 1)
        n_strats = depth + 2
        s_sel = torch.minimum(
            (u[:, 4] * n_strats.to(torch.float32)).to(torch.int32),
            n_strats - 1)
        t_sel = n_strats - s_sel
        L, pr = bdpt_li(ds, r.st, s, self.max_depth, px, py, 0, o, d,
                        self.xres, self.yres, strategy=(s_sel, t_sel),
                        p_raster_cam=p_raster, isect=r._isect,
                        tables=r._shade_tables, with_stats=r.collect_stats)
        bad = ~torch.isfinite(L).all(-1) | (torch.amin(L, -1) < 0.0)
        return torch.where(bad[..., None], 0.0, L), pr

    @torch.no_grad()
    def step(self, u, depth, L_cur, pr_cur, splat, key):
        """One mutation of every chain, its expected-value splats and the
        acceptance. Returns (u, L_cur, pr_cur, splat)."""
        u_prop, _ = mutate(u, key, self.p_large, self.sigma)
        L_prop, pr_prop = self.eval_path(u_prop, depth)
        y_cur = _luminance(L_cur)
        y_prop = _luminance(L_prop)
        a = torch.minimum(torch.ones_like(y_prop),
                          y_prop / y_cur.clamp_min(1e-12))
        a = torch.where(y_cur <= 0.0, torch.where(y_prop > 0, 1.0, 0.0), a)
        # expected-value splats (mlt.cpp:242-246): both states, each
        # weighted by its visit probability over its luminance
        w_prop = torch.where(y_prop > 0, a / y_prop.clamp_min(1e-12), 0.0)
        w_cur = torch.where(y_cur > 0,
                            (1.0 - a) / y_cur.clamp_min(1e-12), 0.0)
        splat = _splat(splat, pr_prop, L_prop * w_prop[:, None],
                       self.xres, self.yres)
        splat = _splat(splat, pr_cur, L_cur * w_cur[:, None],
                       self.xres, self.yres)
        lanes = torch.arange(u.shape[0], dtype=torch.int64, device=u.device)
        acc = rng.uniform_float((key + 3) & M32, lanes, 9) < a
        u = torch.where(acc[:, None], u_prop, u)
        L_cur = torch.where(acc[:, None], L_prop, L_cur)
        pr_cur = torch.where(acc[:, None], pr_prop, pr_cur)
        return u, L_cur, pr_cur, splat

    def bootstrap(self, seed=7):
        """nBootstrap samples PER DEPTH (mlt.cpp:177-186): sets `self.b`
        and returns (the numpy generator, y (md+1, n_bootstrap), u
        (md+1, n_bootstrap, D))."""
        dev = self.r.device
        md = self.max_depth
        gen = np.random.default_rng(seed)
        ys, us = [], []  # [depth][chunk]
        for k in range(md + 1):
            yk, uk = [], []
            for _ in range(0, self.n_bootstrap, self.n):
                u_np = gen.random((self.n, self.n_dims), np.float32)
                L, _ = self.eval_path(
                    torch.from_numpy(u_np).to(dev),
                    torch.full((self.n,), k, dtype=torch.int32, device=dev))
                yk.append(_luminance(L).cpu().numpy())
                uk.append(u_np)
            ys.append(np.concatenate(yk)[: self.n_bootstrap])
            us.append(np.concatenate(uk)[: self.n_bootstrap])
        y_boot = np.stack(ys)
        # b = funcInt * (maxDepth + 1) = sum / nBootstrap (mlt.cpp:186)
        self.b = float(y_boot.sum() / self.n_bootstrap)
        if self.b <= 0:
            self.b = 1e-9
        return gen, y_boot, np.stack(us)

    def render(self, mutations_per_pixel=32, seed=7, verbose=False):
        """The bootstrap, the chains' start (a (depth, bootstrap sample)
        pair picked in proportion to its luminance) and the mutation
        passes. Returns the image (H, W, 3) as numpy; `self.film` holds it
        as splats (splatScale 1), `self.seconds` the host's wall seconds
        of the bootstrap and of the chains (their start and `steps`
        mutation steps; both end on a copy to the host, which waits for
        the device)."""
        dev = self.r.device
        npx = self.xres * self.yres
        t0 = time.time()
        gen, y_boot, us_arr = self.bootstrap(seed)
        t1 = time.time()
        flat = y_boot.reshape(-1)
        cdf = np.cumsum(flat)
        cdf = cdf / max(cdf[-1], 1e-30)
        pick = np.clip(np.searchsorted(cdf, gen.random(self.n)),
                       0, flat.size - 1)
        depth = torch.from_numpy(
            (pick // self.n_bootstrap).astype(np.int32)).to(dev)
        u = torch.from_numpy(us_arr[pick // self.n_bootstrap,
                                    pick % self.n_bootstrap]).to(dev)
        L_cur, pr_cur = self.eval_path(u, depth)

        splat = torch.zeros((npx, 3), device=dev)
        n_steps = max(mutations_per_pixel * npx // self.n, 1)
        for it in range(n_steps):
            key = (seed * 2654435761 + it * 4 + 1) % (1 << 32)
            u, L_cur, pr_cur, splat = self.step(u, depth, L_cur, pr_cur,
                                                splat, key)
            if verbose and (it + 1) % 32 == 0:
                print(f"  mlt step {it + 1}/{n_steps}", flush=True)
        # the estimate: b * splat / totalMutations * npixels (pbrt:
        # splatScale = b / mutationsPerPixel with per-pixel splats); it
        # lands in a Film's splats with splatScale 1 (Film::AddSplat +
        # WriteImage, film.cpp:144-153)
        scale = self.b / (n_steps * self.n) * npx
        self.film = filmmod.new_film(self.xres, self.yres, dev)
        self.film = self.film._replace(splat=splat * scale)
        img = (splat * scale).reshape(self.yres, self.xres, 3).cpu().numpy()
        self.seconds = {"bootstrap": t1 - t0, "chains": time.time() - t1,
                        "steps": n_steps}
        return img
