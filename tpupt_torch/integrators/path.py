"""Wavefront path integrator with NEE + MIS + Russian roulette.

Counterpart of PathIntegrator::Li (integrators/path.cpp:64-204) and
EstimateDirect (core/integrator.cpp:109-217), inverted for a wavefront:
instead of a per-ray bounce recursion, the whole camera-ray batch advances
through the bounce loop together with a live mask, each vertex's sampler
dimensions static exactly like the reference's deterministic dimension
consumption.

Per vertex: intersect -> (MIS-weighted) emitted light -> NEE light sample +
shadow ray -> BSDF sample -> throughput update -> RR. Per-ray traversal
counters accumulate into film AOVs (GeneralStats parity).

Every traversal goes through the wrapper `pick_traversal` returns:
`ops.traverse_wide.intersect_wide_cuda` for single-level tables,
`ops.traverse_treelets.intersect_treelets_cuda` for two-level ones; each
launches its CUDA kernel for tensors on a card and runs its plain PyTorch
walker for CPU tensors.
Rays are not sorted for coherence: one thread walks one ray, so the order of
the batch does not change the answer. The shading chain is written
out-of-place; traversal inputs and hit records are detached, so a later
change can switch autograd on over the material and light tables.
"""

from __future__ import annotations

import math
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.core.sampling import power_heuristic
from tpupt_torch.core.spectrum import luminance
from tpupt_torch.core.vecmath import (absdot, cross, dot, normalize,
                                      offset_ray_origin)
from tpupt_torch.film import film as filmmod
from tpupt_torch.lights.lights import emitted_radiance, pdf_li, sample_li
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.ops import traverse_treelets, traverse_wide
from tpupt_torch.samplers.samplers import WavefrontSampler
from tpupt_torch.scene.device import DeviceScene, SceneStatics, upload
from tpupt_torch.scene.flatten import FlatScene
from tpupt_torch.shapes.quadric import quadric_normal_uv
from tpupt_torch.shapes.sphere import transform_normal

_RR_START = 3  # bounces before RR kicks in (path.cpp:193)
# fixed wavefront batch: one shape of work whatever the resolution
BATCH_RAYS = 131072


class ShadingPoint(NamedTuple):
    p: torch.Tensor       # (N,3)
    ns: torch.Tensor      # shading normal
    ng: torch.Tensor      # geometric normal
    uv: torch.Tensor      # (N,2)
    mat: torch.Tensor     # (N,) i32
    light: torch.Tensor   # (N,) i32 area-light id or -1
    face: torch.Tensor    # (N,) i32 ptex faceIndex (interaction.h:156)


def tri_shade_table(ds):
    """Packed per-triangle shading rows (T, 27): p0 p1 p2 n0 n1 n2 (18) |
    uv0 uv1 uv2 (6) | mat light face as bit-cast i32 (3): one row gather per
    hit instead of twelve. Build it once per render (it is loop-invariant)."""
    ints = torch.stack([ds.tri_mat, ds.tri_light, ds.tri_face],
                       dim=1).to(torch.int32)
    return torch.cat(
        [ds.tri_p0, ds.tri_p1, ds.tri_p2, ds.tri_n0, ds.tri_n1, ds.tri_n2,
         ds.tri_uv0, ds.tri_uv1, ds.tri_uv2, ints.view(torch.float32)], dim=1)


def sph_shade_table(ds):
    """Packed per-quadric shading rows (S, 22): w2o 3x4 row-major (12) |
    kind radius zmin zmax phimax q1 q2 (7, kind as bit-cast i32) |
    reverse mat light (3, bit-cast i32)."""
    kind = ds.sph_kind.to(torch.int32).view(torch.float32)[:, None]
    ints = torch.stack([ds.sph_reverse.to(torch.int32),
                        ds.sph_mat.to(torch.int32),
                        ds.sph_light.to(torch.int32)], dim=1)
    return torch.cat(
        [ds.sph_w2o[:, :3, :].reshape(-1, 12), kind,
         ds.sph_radius[:, None], ds.sph_zmin[:, None],
         ds.sph_zmax[:, None], ds.sph_phimax[:, None],
         ds.sph_q1[:, None], ds.sph_q2[:, None],
         ints.view(torch.float32)], dim=1)


def shading_point(ds: DeviceScene, st: SceneStatics, hit, o, d,
                  tables=None) -> ShadingPoint:
    """SurfaceInteraction assembly (core/interaction.cpp:94 analog).
    Miss lanes get a finite dummy position (inf primals poison reverse mode
    even under masks). `tables` = (tri_shade_table, sph_shade_table) built
    once by the caller; built here when absent."""
    tri_tab, sph_tab = tables or (tri_shade_table(ds), sph_shade_table(ds))
    t_finite = torch.where(hit.valid, hit.t, 1.0)
    p = o + t_finite[..., None] * d
    prim = hit.prim.clamp_min(0)
    is_tri = prim < st.n_tris

    tid = prim.clamp(0, max(st.n_tris - 1, 0)).long()
    b1 = hit.b1
    b2 = hit.b2
    b0 = 1.0 - b1 - b2
    row = tri_tab[tid]
    t_p0, t_p1, t_p2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    t_n0, t_n1, t_n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
    t_uv0, t_uv1, t_uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    t_ints = row[:, 24:27].contiguous().view(torch.int32)
    ns_t = normalize(b0[..., None] * t_n0 + b1[..., None] * t_n1
                     + b2[..., None] * t_n2)
    ng_t = normalize(cross(t_p1 - t_p0, t_p2 - t_p0))
    # keep ng on the same side as ns (triangle.cpp:414 orients ng to ns)
    ng_t = torch.where(dot(ng_t, ns_t)[..., None] < 0.0, -ng_t, ng_t)
    uv_t = (b0[..., None] * t_uv0 + b1[..., None] * t_uv1
            + b2[..., None] * t_uv2)
    mat_t = t_ints[:, 0]
    light_t = t_ints[:, 1]

    sid = (prim - st.n_tris).clamp(0, max(st.n_spheres - 1, 0)).long()
    srow = sph_tab[sid]
    # row layout: 0-11 w2o | 12 kind | 13 radius | 14 zmin | 15 zmax |
    # 16 phimax | 17 q1 | 18 q2 | 19 reverse | 20 mat | 21 light
    s_w2o = srow[:, 0:12].reshape(-1, 3, 4)
    s_kind = srow[:, 12].contiguous().view(torch.int32)
    s_ints = srow[:, 19:22].contiguous().view(torch.int32)
    n_obj, u_s, v_s = quadric_normal_uv(
        hit.p_obj, s_kind, srow[:, 13], srow[:, 14],
        srow[:, 15], srow[:, 16], srow[:, 17], srow[:, 18])
    ns_s = transform_normal(s_w2o, n_obj)
    ns_s = torch.where((s_ints[:, 0] != 0)[..., None], -ns_s, ns_s)
    uv_s = torch.stack([u_s, v_s], -1)
    mat_s = s_ints[:, 1]
    light_s = s_ints[:, 2]

    sel = is_tri[..., None]
    return ShadingPoint(
        p=p,
        ns=torch.where(sel, ns_t, ns_s),
        ng=torch.where(sel, ng_t, ns_s),
        uv=torch.where(sel, uv_t, uv_s),
        mat=torch.where(is_tri, mat_t, mat_s),
        light=torch.where(is_tri, light_t, light_s),
        face=torch.where(is_tri, t_ints[:, 2], 0),
    )


def miss_radiance_and_pdf(ds, st, d):
    """(Le, light-sampling pdf) for escaped rays. Infinite lights are not
    ported yet (the flattener refuses them), so escaped rays see black; the
    pdf is the uniform-sphere one the MIS weight of the BSDF sample uses."""
    n = d.shape[0]
    return d.new_zeros((n, 3)), d.new_full((n,), 1.0 / (4.0 * math.pi))


def pick_traversal(st: SceneStatics):
    """The traversal wrapper for these tables: two-level tables go through
    the treelet kernel, single-level ones through the wide-BVH kernel."""
    if st.two_level:
        return traverse_treelets.intersect_treelets_cuda
    return traverse_wide.intersect_wide_cuda


def path_li(ds: DeviceScene, st: SceneStatics, sampler: WavefrontSampler,
            max_depth: int, rr_threshold: float,
            px, py, sample_idx, o, d, isect=None, tables=None):
    """Trace one batch of camera rays to completion.

    Vertex-count semantics match path.cpp: the bounce loop visits maxDepth
    NEE/scatter vertices plus one final emission-only vertex (path.cpp:82's
    `if (bounces >= maxDepth) break` sits after the emission block), each
    with one closest-hit and one any-hit traversal.

    `isect(ds, st, o, d, tmax, any_hit=False)` -> (Hit, TraversalStats);
    default `pick_traversal(st)`. Returns (L (N,3), aov (N,4))."""
    if isect is None:
        isect = pick_traversal(st)
    if tables is None:
        tables = (tri_shade_table(ds), sph_shade_table(ds))

    def intersect(o_, d_, tmax_, any_hit=False):
        # traversal is non-differentiable (integer hit ids): its inputs and
        # its hit record are detached, so cotangents reach materials and
        # lights through the shading chain only
        hit, stats = isect(ds, st, o_.detach().contiguous(),
                           d_.detach().contiguous(),
                           tmax_.detach().contiguous(), any_hit=any_hit)
        return hit, stats

    n = o.shape[0]
    dev = o.device
    i32 = torch.int32

    inf_pmf = 1.0 / max(st.n_lights, 1)
    tmax_init = o.new_full((n,), math.inf)
    light_cdf = torch.cumsum(ds.light_pdf, 0)

    def grid_cdf_row(p):
        """Per-point light-choice cdf row from the spatial voxel grid
        (SpatialLightDistribution::Lookup, lightdistrib.cpp:120)."""
        g = round(ds.light_grid_cdf.shape[0] ** (1.0 / 3.0))
        ext = (ds.world_hi - ds.world_lo).clamp_min(1e-6)
        v = ((p - ds.world_lo) / ext * g).to(torch.int64).clamp(0, g - 1)
        flat = (v[..., 0] * g + v[..., 1]) * g + v[..., 2]
        return ds.light_grid_cdf[flat]  # (N, L)

    def row_pmf(row, lid):
        hi = row.gather(-1, lid.long()[..., None])[..., 0]
        lo = torch.where(
            lid > 0,
            row.gather(-1, (lid - 1).clamp_min(0).long()[..., None])[..., 0],
            0.0)
        return (hi - lo).clamp_min(1e-12)

    def pick_light(u, p):
        """(light id, pmf) under the active strategy."""
        if st.spatial_lights:
            row = grid_cdf_row(p)
            lid = torch.sum(u[..., None] > row, -1).clamp(
                0, st.n_lights - 1).to(i32)
            return lid, row_pmf(row, lid)
        lid = torch.searchsorted(light_cdf, u.contiguous(), right=True).clamp(
            0, st.n_lights - 1).to(i32)
        return lid, ds.light_pdf[lid.long()]

    def light_pmf_at(p, lid):
        """pmf the strategy assigns to light lid from point p (for MIS)."""
        if st.spatial_lights:
            return row_pmf(grid_cdf_row(p), lid)
        return ds.light_pdf[lid.long()]

    L = o.new_zeros((n, 3))
    beta = o.new_ones((n, 3))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_specular = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = o.new_ones(n)
    prev_p = o
    eta_scale = o.new_ones(n)
    aov_nodes = torch.zeros(n, dtype=i32, device=dev)
    aov_leaves = torch.zeros(n, dtype=i32, device=dev)
    aov_tests = torch.zeros(n, dtype=i32, device=dev)
    path_len = torch.zeros(n, dtype=i32, device=dev)

    for bounce in range(max_depth + 1):
        is_last = bounce >= max_depth  # emission-only final vertex

        hit, tstats = intersect(o, d, torch.where(alive, tmax_init, 0.0))
        aov_nodes = aov_nodes + torch.where(alive, tstats.node_visits, 0)
        aov_leaves = aov_leaves + torch.where(alive, tstats.leaf_visits, 0)
        aov_tests = aov_tests + torch.where(alive, tstats.prim_tests, 0)
        path_len = path_len + alive.to(i32)

        sp = shading_point(ds, st, hit, o, d, tables)
        wo = -d

        # ---- emitted radiance at the hit (path.cpp:97-113) ----
        if st.n_lights > 0:
            le = emitted_radiance(ds, st, hit.prim, sp.light, wo, sp.ns)
            le = torch.where((alive & hit.valid)[..., None], le, 0.0)
            # clamp inf miss-t BEFORE any differentiable expression
            t_safe = torch.where(hit.valid, hit.t, 1.0)
            lp = pdf_li(ds, st, prev_p, d, hit.prim.clamp_min(0), t_safe)
            lp = torch.where(hit.valid, lp, 0.0)
            lid0 = sp.light.clamp(0, max(st.n_lights - 1, 0))
            pmf0 = light_pmf_at(prev_p, lid0)
            w_bsdf = power_heuristic(1.0, prev_pdf, 1.0, lp * pmf0)
            w = torch.where(prev_specular, 1.0, w_bsdf)
            L = L + beta * le * w[..., None]

            # miss -> infinite lights (path.cpp:100-107)
            miss = alive & ~hit.valid
            miss_le, miss_pdf = miss_radiance_and_pdf(ds, st, d)
            w_inf = torch.where(
                prev_specular, 1.0,
                power_heuristic(1.0, prev_pdf, 1.0, miss_pdf * inf_pmf))
            L = L + torch.where(miss[..., None],
                                beta * miss_le * w_inf[..., None], 0.0)

        alive = alive & hit.valid & (not is_last)

        # per-bounce sample dims (the final vertex, whose shading results
        # are masked out anyway, reuses the last bounce's)
        base = 5 + min(bounce, max(max_depth - 1, 0)) * 7
        ub = [sampler.dim(px, py, sample_idx, base + k) for k in range(7)] \
            if max_depth > 0 else [o.new_zeros(n)] * 7

        # ---- material gather + local frame ----
        mp = bx.gather_mat_params(ds, sp.mat, uv=sp.uv)
        t_f, b_f, n_f = bx.make_frame(sp.ns)
        wo_l = bx.to_local(t_f, b_f, n_f, wo)

        # ---- NEE (UniformSampleOneLight, integrator.cpp:86) ----
        if st.n_lights > 0:
            lid, pmf = pick_light(ub[0], sp.p)
            ls = sample_li(ds, st, lid, sp.p, ub[1], ub[2])
            wi_l = bx.to_local(t_f, b_f, n_f, ls.wi)
            f_l, pdf_b = bx.eval_pdf(mp, wo_l, wi_l)
            f_l = f_l * absdot(ls.wi, sp.ns)[..., None]
            can = alive & (ls.pdf > 0.0) & (torch.amax(f_l, -1) > 0.0)
            # shadow ray (VisibilityTester::Unoccluded, light.h:99)
            o_sh = offset_ray_origin(sp.p, sp.ng, ls.wi)
            shit, sstats = intersect(
                o_sh, ls.wi, torch.where(can, ls.dist * 0.999, 0.0),
                any_hit=True)
            occluded = shit.valid
            aov_nodes = aov_nodes + torch.where(can, sstats.node_visits, 0)
            aov_tests = aov_tests + torch.where(can, sstats.prim_tests, 0)
            # MIS weight over the effective light-strategy density
            # ls.pdf * pmf: the BSDF-hit side (above) weighs against
            # lp * pmf, so both strategies see the same density and the
            # pair sums to 1 (EstimateDirect, integrator.cpp:130)
            w_l = torch.where(ls.is_delta, 1.0,
                              power_heuristic(1.0, ls.pdf * pmf, 1.0, pdf_b))
            contrib = beta * f_l * ls.li * (
                w_l / (ls.pdf * pmf).clamp_min(1e-12))[..., None]
            L = L + torch.where((can & ~occluded)[..., None], contrib, 0.0)

        # ---- BSDF sampling (path.cpp:144-160) ----
        bs = bx.sample(mp, wo_l, ub[3], ub[4], ub[5])
        wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
        cos_w = absdot(wi_w, sp.ns)
        ok = bs.pdf > 1e-9
        thru = bs.f * (cos_w / bs.pdf.clamp_min(1e-9))[..., None]

        beta = beta * torch.where((ok & alive)[..., None], thru,
                                  torch.where(alive[..., None], 0.0, 1.0))
        alive = alive & ok & (torch.amax(beta, -1) > 0.0)
        eta_scale = eta_scale * torch.where(alive, bs.eta_scale, 1.0)
        prev_specular = torch.where(alive, bs.specular, prev_specular)
        prev_pdf = torch.where(alive, bs.pdf.clamp_min(1e-12), prev_pdf)
        prev_p = torch.where(alive[..., None], sp.p, prev_p)

        # ---- spawn next ray ----
        o = torch.where(alive[..., None],
                        offset_ray_origin(sp.p, sp.ng, wi_w), o)
        d = torch.where(alive[..., None], wi_w, d)

        # ---- russian roulette (path.cpp:193-199) ----
        rr_beta = torch.amax(beta * eta_scale[..., None], -1)
        q = (1.0 - rr_beta).clamp_min(0.05)
        do_rr = (rr_beta < rr_threshold) & alive & (bounce >= _RR_START)
        die = do_rr & (ub[6] < q)
        alive = alive & ~die
        denom = torch.where(do_rr & ~die, (1.0 - q).clamp_min(1e-6), 1.0)
        beta = torch.where(die[..., None], 0.0, beta / denom[..., None])

    aov = torch.stack([aov_nodes.to(torch.float32),
                       aov_leaves.to(torch.float32),
                       aov_tests.to(torch.float32),
                       path_len.to(torch.float32)], -1)
    return L, aov


def _pixel_order(cfg):
    """Pixels of the crop window in 32x32 tiles, as (px, py) int32 arrays
    (cf. the reference's 16x16 tiles, integrator.cpp:237): neighbouring
    lanes of a batch trace neighbouring pixels. Film accumulation does not
    depend on the order."""
    xres, yres = cfg.xres, cfg.yres
    px, py = np.meshgrid(np.arange(xres, dtype=np.int32),
                         np.arange(yres, dtype=np.int32), indexing="xy")
    # crop window (pbrt.cpp:94, film.cpp GetSampleBounds)
    cx0, cx1, cy0, cy1 = cfg.crop
    mask = ((px >= cx0 * xres) & (px < max(cx1 * xres, cx0 * xres + 1))
            & (py >= cy0 * yres) & (py < max(cy1 * yres, cy0 * yres + 1)))
    pxf = px.ravel()[mask.ravel()]
    pyf = py.ravel()[mask.ravel()]
    tile_key = ((pyf // 32).astype(np.int64) * ((xres + 31) // 32)
                + pxf // 32) * 1024 + (pyf % 32) * 32 + pxf % 32
    order = np.argsort(tile_key)
    return pxf[order], pyf[order]


class Renderer:
    """SamplerIntegrator::Render counterpart (integrator.cpp:230): drives
    sample-indexed full-frame wavefronts and accumulates the film.

    device="cuda" (the default) needs a card and raises without one; pass
    device="cpu" for the plain PyTorch path. `tables=(DeviceScene,
    SceneStatics)` renders from tables built elsewhere instead of calling
    `upload` (the parity tests hand over the JAX package's tables)."""

    def __init__(self, scene: FlatScene, device="cuda",
                 light_strategy: str = None, tables=None, isect=None):
        if scene.integrator.name != "path":
            raise NotImplementedError(
                f"integrator {scene.integrator.name!r} is not in the PyTorch "
                "port yet (ROADMAP.md queue 1, item 11)")
        accel = (scene.accelerator_name or "bvh").lower()
        if accel not in ("bvh", "bvhold"):
            raise NotImplementedError(
                f"accelerator {accel!r} is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 9)")
        self.device = torch.device(device)
        self.scene = scene
        strategy = light_strategy or scene.integrator.light_strategy
        t0 = _time.time()
        self.ds, self.st = tables or upload(
            scene, light_strategy=strategy, device=self.device)
        self.upload_seconds = _time.time() - t0
        self.sampler = WavefrontSampler(
            scene.sampler.name, scene.film.xres, scene.film.yres,
            scene.sampler.spp, scene.sampler.seed)
        self.cfg = scene.film
        self._isect = isect or pick_traversal(self.st)
        self._shade_tables = (tri_shade_table(self.ds),
                              sph_shade_table(self.ds))

        pxf, pyf = _pixel_order(self.cfg)
        # fixed-size wavefront batches; the tail is padded and masked
        self.batch = min(BATCH_RAYS,
                         1 << int(np.ceil(np.log2(max(len(pxf), 1024)))))
        npad = (-len(pxf)) % self.batch
        valid = np.ones(len(pxf) + npad, bool)
        if npad:
            valid[len(pxf):] = False
            pxf = np.concatenate([pxf, np.zeros(npad, np.int32)])
            pyf = np.concatenate([pyf, np.zeros(npad, np.int32)])
        self.n_batches = len(pxf) // self.batch
        nb = self.n_batches
        self._px_b = torch.from_numpy(pxf).to(self.device).reshape(nb, -1)
        self._py_b = torch.from_numpy(pyf).to(self.device).reshape(nb, -1)
        self._valid_b = torch.from_numpy(valid).to(self.device).reshape(nb, -1)
        self._spp_rendered = 0

    def _step(self, film, sample_idx, px_b, py_b, valid_b):
        """One batch of one sample: camera rays -> path_li -> film."""
        scene, cam, ds = self.scene, self.scene.camera, self.ds
        sampler = self.sampler
        jx, jy = sampler.camera_jitter(px_b, py_b, sample_idx)
        p_raster = torch.stack([px_b.to(torch.float32) + jx,
                                py_b.to(torch.float32) + jy], -1)
        ul1 = sampler.dim(px_b, py_b, sample_idx, 2)
        ul2 = sampler.dim(px_b, py_b, sample_idx, 3)
        o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                             p_raster, torch.stack([ul1, ul2], -1),
                             cam.lens_radius, cam.focal_distance)
        L, aov = path_li(ds, self.st, sampler, scene.integrator.max_depth,
                         scene.integrator.rr_threshold, px_b, py_b,
                         sample_idx, o, d, isect=self._isect,
                         tables=self._shade_tables)
        # NaN/inf clamping to black (integrator.cpp:300-321): the reference
        # kills samples with NEGATIVE LUMINANCE (y < -1e-5), not per-channel
        # negatives
        bad = ~torch.isfinite(L).all(-1) | (luminance(L) < -1e-5)
        L = torch.where(bad[..., None], 0.0, L)
        if np.isfinite(self.cfg.max_sample_luminance):
            lum = luminance(L)
            s = torch.where(lum > self.cfg.max_sample_luminance,
                            self.cfg.max_sample_luminance / lum.clamp_min(1e-9),
                            1.0)
            L = L * s[..., None]
        return filmmod.add_samples(film, self.cfg, p_raster, L, aov,
                                   mask=valid_b)

    @torch.no_grad()
    def _spp(self, film, sample_idx: int):
        """One full sample over every batch."""
        for b in range(self.n_batches):
            film = self._step(film, int(sample_idx), self._px_b[b],
                              self._py_b[b], self._valid_b[b])
        return film

    def new_film(self):
        return filmmod.new_film(self.cfg.xres, self.cfg.yres, self.device)

    def render(self, spp: int = None, film=None, verbose: bool = False):
        spp = spp or self.scene.sampler.spp
        if film is None:
            self._spp_rendered = spp
            film = self.new_film()
        else:
            self._spp_rendered += spp
        t0 = _time.time()
        for s in range(spp):
            film = self._spp(film, s)
            if verbose:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                print(f"  sample {s + 1}/{spp}  ({_time.time() - t0:.1f}s)",
                      flush=True)
        return film

    def image(self, film):
        return filmmod.to_image(film, self.cfg).cpu().numpy()

    def aovs(self, film):
        return {k: v.cpu().numpy()
                for k, v in filmmod.aov_images(film, self.cfg).items()}
