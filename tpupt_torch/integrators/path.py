"""Wavefront path integrator with NEE + MIS + Russian roulette.

Counterpart of PathIntegrator::Li (integrators/path.cpp:64-204) and
EstimateDirect (core/integrator.cpp:109-217), inverted for a wavefront:
instead of a per-ray bounce recursion, the whole camera-ray batch advances
through the bounce loop together with a live mask, each vertex's sampler
dimensions static exactly like the reference's deterministic dimension
consumption.

Per vertex: intersect -> (MIS-weighted) emitted light -> NEE light sample +
shadow ray -> BSDF sample -> (in a scene with subsurface materials: the
BSSRDF exit probe, NEE and its shadow ray at the exit) -> throughput update
-> RR. Per-ray traversal
counters accumulate into film AOVs (GeneralStats parity).

Every traversal goes through the wrapper `pick_traversal` returns:
`ops.traverse_wide.intersect_wide_cuda` for single-level BVH tables,
`ops.traverse_treelets.intersect_treelets_cuda` for two-level ones,
`ops.traverse_kdbsp.intersect_kdbsp_cuda` for the kd / RBSP / BSP trees; each
launches its CUDA kernel for tensors on a card and runs its plain PyTorch
walker for CPU tensors.
Rays are not sorted for coherence, where the JAX package sorts every call of
its two-level path and the secondary and shadow rays of its kd path: one
thread walks one ray, so the order changes no answer, and on the H100 that
sort cost more than it saved on each of those paths (PERF.md). The shading
chain is written out-of-place; traversal inputs and hit records are
detached, so a later change can switch autograd on over the material and
light tables.
"""

from __future__ import annotations

import math
import os
import time as _time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from tpupt_torch.accel import kdbsp
from tpupt_torch.accel import traverse as trav
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.cameras.realistic import bound_exit_pupil, realistic_rays
from tpupt_torch.core import rng
from tpupt_torch.core.rng import M32, as_u32
from tpupt_torch.core.sampling import cosine_sample_hemisphere, power_heuristic
from tpupt_torch.core.spectrum import (N_SPECTRAL_SAMPLES, luminance,
                                       rgb_to_spectrum, sampled_to_rgb)
from tpupt_torch.core.vecmath import (absdot, coordinate_system, cross, dot,
                                      normalize, offset_ray_origin, safe_sqrt)
from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators.replay import HitRecorder, Replay
from tpupt_torch.lights.lights import (emitted_radiance, env_pdf,
                                       env_radiance, pdf_li, sample_li)
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.materials.bssrdf import sss_exit, sw_lobe
from tpupt_torch.media.media import build_medium
from tpupt_torch.ops import (traverse_kdbsp, traverse_requeue,
                             traverse_treelets, traverse_wide)
from tpupt_torch.samplers.samplers import WavefrontSampler
from tpupt_torch.scene.device import (DeviceScene, SceneStatics, upload,
                                      with_alt_accel)
from tpupt_torch.scene.flatten import LIGHT_INFINITE, FlatScene
from tpupt_torch.shapes.quadric import quadric_normal_uv
from tpupt_torch.shapes.sphere import transform_normal
from tpupt_torch.utils import logging as tlog

_RR_START = 3  # bounces before RR kicks in (path.cpp:193)
# the integrators spectral transport covers (the others warn and render RGB)
SPECTRAL_INTEGRATORS = ("path", "volpath", "bdpt", "mlt", "directlighting",
                        "whitted", "ambientocclusion")
# the integrators `value_and_grad` and the training step differentiate:
# every one `Renderer` renders (mlt and sppm estimate with path_li there,
# as the JAX package's step does; their own drivers, integrators/mlt.py and
# sppm.py, have no gradient in either package)
GRADIENT_INTEGRATORS = ("path", "volpath", "directlighting", "whitted",
                        "ambientocclusion", "bdpt", "mlt", "sppm")
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


def _infinite_light_le(ds, st):
    """Constant-radiance sum of the infinite lights without a map (the
    env-mapped light's L is baked into its map)."""
    if st.n_lights == 0:
        return ds.light_L.new_zeros(3)
    is_inf = ds.light_type == LIGHT_INFINITE
    if st.env_light_id >= 0:
        idx = torch.arange(ds.light_type.shape[0], device=is_inf.device)
        is_inf = is_inf & (idx != st.env_light_id)
    return torch.sum(torch.where(is_inf[:, None], ds.light_L, 0.0), 0)


def miss_radiance_and_pdf(ds, st, d):
    """(Le, light-sampling pdf) for escaped rays: env-map radiance plus the
    constant infinite lights; the pdf is the one the MIS weight of the BSDF
    sample uses (the env sampler's, else the uniform sphere's)."""
    n = d.shape[0]
    le = _infinite_light_le(ds, st).expand(n, 3)
    pdf = d.new_full((n,), 1.0 / (4.0 * math.pi))
    if st.env_w > 0:
        le = le + env_radiance(ds, st, d)
        pdf = env_pdf(ds, st, d)
    return le, pdf


def ray_cone_footprint(ds, st, hit, d, sp, tri_tab):
    """Texture footprint of a hit for MIP selection: the ray-cone stand-in
    for RayDifferential::ScaleDifferentials. Returns (width (N,), the uv
    major axis (N,2)): the pixel cone's angle x hit distance x the hit
    triangle's uv density, and the major diameter of the cone's ellipse on
    the surface (cone * t / |cos|, eccentricity clamped at the reference's
    MaxAnisotropy 8, mipmap.h:180) projected onto the triangle's uv
    parametrization. Both carry the camera matrices' gradient through the
    cone angle and the ray direction."""
    pix_cone = torch.linalg.norm(ds.raster_to_camera[:3, 1])
    prim0 = hit.prim.clamp_min(0)
    on_tri = prim0 < st.n_tris
    row = tri_tab[prim0.clamp_max(max(st.n_tris - 1, 0)).long()]
    p0, p1, p2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    uv0, uv1, uv2 = row[:, 18:20], row[:, 20:22], row[:, 22:24]
    e1, e2 = p1 - p0, p2 - p0
    w_area = 0.5 * torch.linalg.norm(cross(e1, e2), dim=-1)
    du1, du2 = uv1 - uv0, uv2 - uv0
    det_uv = du1[..., 0] * du2[..., 1] - du1[..., 1] * du2[..., 0]
    uv_area = 0.5 * torch.abs(det_uv)
    dens = torch.sqrt(uv_area / w_area.clamp_min(1e-12))
    dens = torch.where(on_tri, dens, 1.0)
    t_hit = torch.where(hit.valid, hit.t, 1.0)
    width = pix_cone * t_hit * dens

    cos_i = torch.abs(dot(d, sp.ns))
    h = d - dot(d, sp.ns)[..., None] * sp.ns
    # |h| through safe_sqrt: finite partials at normal incidence (h = 0)
    h_len = safe_sqrt(dot(h, h))
    h_unit = h / h_len.clamp_min(1e-12)[..., None]
    major_w = pix_cone * t_hit / cos_i.clamp_min(1.0 / 8.0)
    a = h_unit * major_w[..., None]
    # dpdu / dpdv from the uv deltas (triangle.cpp:87)
    inv_det = torch.where(torch.abs(det_uv) > 1e-12, 1.0 / det_uv, 0.0)
    dpdu = (du2[..., 1:2] * e1 - du1[..., 1:2] * e2) * inv_det[..., None]
    dpdv = (-du2[..., 0:1] * e1 + du1[..., 0:1] * e2) * inv_det[..., None]
    g11, g12, g22 = dot(dpdu, dpdu), dot(dpdu, dpdv), dot(dpdv, dpdv)
    det_g = g11 * g22 - g12 * g12
    b1_, b2_ = dot(a, dpdu), dot(a, dpdv)
    ok_g = (torch.abs(det_g) > 1e-18) & on_tri & (h_len > 1e-9)
    inv_g = torch.where(ok_g, 1.0 / torch.where(ok_g, det_g, 1.0), 0.0)
    du_ = (g22 * b1_ - g12 * b2_) * inv_g
    dv_ = (g11 * b2_ - g12 * b1_) * inv_g
    aniso = torch.where(ok_g[..., None], torch.stack([du_, dv_], -1), 0.0)
    return width, aniso


def pick_traversal(st: SceneStatics, alt: bool = False):
    """The traversal wrapper for these tables: with `alt` the kd / RBSP / BSP
    tree goes through the kd/BSP kernel (which ignores the rays' time);
    else a motion scene goes through the wide-BVH kernel's motion instance,
    two-level or not (the two-level upload keeps the single-level tables the
    treelets were cut from, as the JAX package sends its motion scenes to
    its wide walker), two-level BVH tables through the treelet kernel and
    single-level ones through the wide-BVH kernel. Each takes `with_stats`
    (path_li hands it the Renderer's `collect_stats`): its kernel counts
    only with it, its plain walker, which CPU tensors take, always counts,
    as the JAX package's XLA walkers do."""
    if alt:
        kdbsp.check_tree(st)
        return traverse_kdbsp.intersect_kdbsp_cuda
    if st.two_level and not st.has_motion:
        return traverse_treelets.intersect_treelets_cuda
    return traverse_wide.intersect_wide_cuda


TRAVERSAL_KINDS = {traverse_wide.intersect_wide_cuda: "K1",
                   traverse_kdbsp.intersect_kdbsp_cuda: "K2",
                   traverse_treelets.intersect_treelets_cuda: "K3",
                   traverse_requeue.intersect_requeue: "re-queue"}


def traversal_kind(isect) -> str:
    """The `kind` of the `traverse` spans of `isect`: K1, K2 or K3 for the
    wrappers `pick_traversal` hands out (on CPU tensors their plain
    walkers), `re-queue` for the re-queue driver, the recorded traversal's
    kind for `value_and_grad`'s pass 1, `replay` for its pass 2 (which
    launches no traversal), else the callable's name."""
    if isinstance(isect, Replay):
        return "replay"
    inner = getattr(isect, "__self__", None)
    if isinstance(inner, HitRecorder):
        return traversal_kind(inner.isect)
    return TRAVERSAL_KINDS.get(isect) or getattr(
        isect, "__name__", type(isect).__name__)


def detached_traversal(isect, ds: DeviceScene, st: SceneStatics,
                       with_stats: bool, time=None):
    """`intersect(o, d, tmax, any_hit=False)` -> (Hit, TraversalStats) over
    `isect` with everything it is handed and everything it returns detached:
    traversal is non-differentiable (integer hit ids), so cotangents reach
    materials, lights and the camera through the shading chain only (the
    detached-sampling estimator). `time` (N,) goes to every call in a
    motion scene. Each call is a `traverse` span (count: its lanes; kind:
    `traversal_kind(isect)`)."""
    ds_trav = ds._replace(**{k: v.detach() for k, v in ds._asdict().items()
                             if isinstance(v, torch.Tensor) and v.requires_grad})
    kw_time = ({"time": time.detach().contiguous()}
               if time is not None and st.has_motion else {})
    kind = traversal_kind(isect)

    def intersect(o_, d_, tmax_, any_hit=False):
        with tlog.annotate("traverse", count=o_, kind=kind):
            hit, stats = isect(ds_trav, st, o_.detach().contiguous(),
                               d_.detach().contiguous(),
                               tmax_.detach().contiguous(), any_hit=any_hit,
                               with_stats=with_stats, **kw_time)
            return trav.Hit(*(x.detach() for x in hit)), stats
    return intersect


def uplift(st: SceneStatics):
    """The colour uplift of the scene's transport: `rgb_to_spectrum` under
    60-bin spectral transport, else the identity (nothing is dispatched)."""
    if st.n_channels == 3:
        return lambda x: x
    if st.n_channels != N_SPECTRAL_SAMPLES:
        raise ValueError(f"n_channels={st.n_channels}: 3 (RGB) or "
                         f"{N_SPECTRAL_SAMPLES} (spectral)")
    return rgb_to_spectrum


def path_li(ds: DeviceScene, st: SceneStatics, sampler: WavefrontSampler,
            max_depth: int, rr_threshold: float,
            px, py, sample_idx, o, d, isect=None, tables=None,
            with_stats: bool = True, time=None):
    """Trace one batch of camera rays to completion.

    Vertex-count semantics match path.cpp: the bounce loop visits maxDepth
    NEE/scatter vertices plus one final emission-only vertex (path.cpp:82's
    `if (bounces >= maxDepth) break` sits after the emission block), each
    with one closest-hit and one any-hit traversal.

    `isect(ds, st, o, d, tmax, any_hit=False, with_stats=True)` -> (Hit,
    TraversalStats), called with `with_stats`; default `pick_traversal(st)`.
    `time` (N,), the rays' shutter time, goes to every traversal of the
    path (the closest hit, the NEE shadow ray, the subsurface probe and its
    exit's shadow ray) as `isect(..., time=time)` in a motion scene; in a
    static one (an animated camera has used it already) and without it
    `isect` gets no `time`.

    Spectral transport (st.n_channels == 60, SampledSpectrum): every colour
    is uplifted where it enters the throughput chain (the light sample's
    f and Li separately: their product is a metamer product), beta and L
    are (N, 60), and L goes back to RGB after the loop.

    Spans (utils/logging.py): a `bounce` a vertex (count: its depth), in it
    the closest hit's `traverse`, then `shade` (shading point, emission,
    material gather), `nee` (light sample, shadow ray), `bsdf` (BSDF and
    subsurface sampling) and `continue` (spawn, Russian roulette).
    Returns (L (N,3), aov (N,4))."""
    if isect is None:
        isect = pick_traversal(st)
    if tables is None:
        tables = (tri_shade_table(ds), sph_shade_table(ds))
    intersect = detached_traversal(isect, ds, st, with_stats, time)
    spec = uplift(st)
    n_chan = st.n_channels

    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    feats = st.mat_features

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

    L = o.new_zeros((n, n_chan))
    beta = o.new_ones((n, n_chan))
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
        with tlog.annotate("bounce", count=bounce):
            is_last = bounce >= max_depth  # emission-only final vertex

            hit, tstats = intersect(o, d,
                                    torch.where(alive, tmax_init, 0.0))
            aov_nodes = aov_nodes + torch.where(alive, tstats.node_visits, 0)
            aov_leaves = aov_leaves + torch.where(alive, tstats.leaf_visits,
                                                  0)
            aov_tests = aov_tests + torch.where(alive, tstats.prim_tests, 0)
            path_len = path_len + alive.to(i32)

            with tlog.annotate("shade"):
                sp = shading_point(ds, st, hit, o, d, tables)
                wo = -d

                # ---- emitted radiance at the hit (path.cpp:97-113) ----
                if st.n_lights > 0:
                    le = emitted_radiance(ds, st, hit.prim, sp.light, wo,
                                          sp.ns)
                    le = torch.where((alive & hit.valid)[..., None], le, 0.0)
                    # clamp inf miss-t BEFORE any differentiable expression
                    t_safe = torch.where(hit.valid, hit.t, 1.0)
                    lp = pdf_li(ds, st, prev_p, d, hit.prim.clamp_min(0),
                                t_safe)
                    lp = torch.where(hit.valid, lp, 0.0)
                    lid0 = sp.light.clamp(0, max(st.n_lights - 1, 0))
                    pmf0 = light_pmf_at(prev_p, lid0)
                    w_bsdf = power_heuristic(1.0, prev_pdf, 1.0, lp * pmf0)
                    w = torch.where(prev_specular, 1.0, w_bsdf)
                    L = L + beta * spec(le) * w[..., None]

                    # miss -> infinite lights (path.cpp:100-107)
                    miss = alive & ~hit.valid
                    miss_le, miss_pdf = miss_radiance_and_pdf(ds, st, d)
                    if st.spatial_lights and st.env_light_id >= 0:
                        inf_pmf_r = light_pmf_at(prev_p, torch.full(
                            (n,), st.env_light_id, dtype=i32, device=dev))
                    else:
                        inf_pmf_r = inf_pmf
                    w_inf = torch.where(
                        prev_specular, 1.0,
                        power_heuristic(1.0, prev_pdf, 1.0,
                                        miss_pdf * inf_pmf_r))
                    L = L + torch.where(
                        miss[..., None],
                        beta * spec(miss_le) * w_inf[..., None], 0.0)

                alive = alive & hit.valid & (not is_last)

                # per-bounce sample dims (the final vertex, whose shading
                # results are masked out anyway, reuses the last bounce's)
                base = 5 + min(bounce, max(max_depth - 1, 0)) * 7
                ub = ([sampler.dim(px, py, sample_idx, base + k)
                       for k in range(7)]
                      if max_depth > 0 else [o.new_zeros(n)] * 7)

                # ---- material gather + local frame ----
                tex_width = tex_aniso = None
                if st.has_textures:
                    tex_width, tex_aniso = ray_cone_footprint(
                        ds, st, hit, d, sp, tables[0])
                mp = bx.gather_mat_params(
                    ds, sp.mat, uv=sp.uv, p=sp.p, face=sp.face,
                    has_textures=st.has_textures, tex_width=tex_width,
                    tex_aniso=tex_aniso, tex_types=st.tex_types,
                    has_mix="mix" in feats, fourier_meta=st.fourier)
                t_f, b_f, n_f = bx.make_frame(sp.ns)
                wo_l = bx.to_local(t_f, b_f, n_f, wo)

            with tlog.annotate("nee"):
                # ---- NEE (UniformSampleOneLight, integrator.cpp:86) ----
                if st.n_lights > 0:
                    lid, pmf = pick_light(ub[0], sp.p)
                    ls = sample_li(ds, st, lid, sp.p, ub[1], ub[2])
                    wi_l = bx.to_local(t_f, b_f, n_f, ls.wi)
                    f_l, pdf_b = bx.eval_pdf(mp, wo_l, wi_l, feats,
                                             st.mix_features)
                    f_l = f_l * absdot(ls.wi, sp.ns)[..., None]
                    can = alive & (ls.pdf > 0.0) & (torch.amax(f_l, -1) > 0.0)
                    # shadow ray (VisibilityTester::Unoccluded, light.h:99)
                    o_sh = offset_ray_origin(sp.p, sp.ng, ls.wi)
                    shit, sstats = intersect(
                        o_sh, ls.wi, torch.where(can, ls.dist * 0.999, 0.0),
                        any_hit=True)
                    occluded = shit.valid
                    aov_nodes = aov_nodes + torch.where(
                        can, sstats.node_visits, 0)
                    aov_tests = aov_tests + torch.where(
                        can, sstats.prim_tests, 0)
                    # MIS weight over the effective light-strategy density
                    # ls.pdf * pmf: the BSDF-hit side (above) weighs against
                    # lp * pmf, so both strategies see the same density and
                    # the pair sums to 1 (EstimateDirect, integrator.cpp:130)
                    w_l = torch.where(
                        ls.is_delta, 1.0,
                        power_heuristic(1.0, ls.pdf * pmf, 1.0, pdf_b))
                    contrib = beta * spec(f_l) * spec(ls.li) * (
                        w_l / (ls.pdf * pmf).clamp_min(1e-12))[..., None]
                    L = L + torch.where((can & ~occluded)[..., None],
                                        contrib, 0.0)

            with tlog.annotate("bsdf"):
                # ---- BSDF sampling (path.cpp:144-160) ----
                bs = bx.sample(mp, wo_l, ub[3], ub[4], ub[5], feats,
                               st.mix_features)
                wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
                cos_w = absdot(wi_w, sp.ns)
                ok = bs.pdf > 1e-9
                thru = spec(bs.f) * (cos_w
                                     / bs.pdf.clamp_min(1e-9))[..., None]
                spawn_p, spawn_ng = sp.p, sp.ng
                bs_specular, bs_pdf = bs.specular, bs.pdf

                if "sss" in feats:
                    # BSSRDF: lanes that transmitted through a subsurface
                    # interface resume the path at a sampled exit point with
                    # its own NEE and the Sw exit lobe (path.cpp:167-189;
                    # bssrdf.cpp Sample_S): two more traversals, the probe
                    # and the exit's shadow ray
                    is_sss = ((mp.type == bx.MAT_SUBSURFACE)
                              | (mp.type == bx.MAT_KDSUBSURFACE))
                    entered = (alive & ok & is_sss
                               & (bs.wi[..., 2] * wo_l[..., 2] < 0.0))
                    key_sss = rng.hash_combine(
                        rng.hash_combine(
                            (as_u32(px) * 7919 + as_u32(py)) & M32,
                            sample_idx),
                        1000 + bounce)
                    pe, ne, w_prof, c_norm, ok_sss = sss_exit(
                        ds, st, mp, sp, entered, key_sss,
                        lambda o_, d_, t_: intersect(o_, d_, t_)[0],
                        lambda h_, o_, d_: shading_point(ds, st, h_, o_, d_,
                                                         tables))
                    eta1 = mp.eta[..., 0]
                    # throughput AT the exit
                    beta_exit = beta * thru * spec(w_prof)
                    te, be_ = coordinate_system(ne)

                    # NEE at the exit vertex (UniformSampleOneLight)
                    if st.n_lights > 0:
                        lid_e, pmf_e = pick_light(
                            rng.uniform_float(key_sss, 110), pe)
                        ls_e = sample_li(ds, st, lid_e, pe,
                                         rng.uniform_float(key_sss, 111),
                                         rng.uniform_float(key_sss, 112))
                        cos_e = dot(ls_e.wi, ne)
                        f_sw = sw_lobe(eta1, c_norm, cos_e)
                        can_e = (entered & ok_sss & (ls_e.pdf > 0.0)
                                 & (cos_e > 1e-6))
                        o_she = offset_ray_origin(pe, ne, ls_e.wi)
                        occ_e = intersect(
                            o_she, ls_e.wi,
                            torch.where(can_e, ls_e.dist * 0.997, 0.0),
                            any_hit=True)[0].valid
                        w_mis = torch.where(
                            ls_e.is_delta, 1.0,
                            power_heuristic(1.0, ls_e.pdf * pmf_e, 1.0,
                                            cos_e.clamp_min(0.0) / math.pi))
                        contrib_e = beta_exit * (f_sw * cos_e * w_mis / (
                            ls_e.pdf * pmf_e).clamp_min(1e-12))[..., None] * (
                                spec(ls_e.li))
                        L = L + torch.where((can_e & ~occ_e)[..., None],
                                            contrib_e, 0.0)

                    # Sw exit continuation: cosine hemisphere at ne
                    wi_le = cosine_sample_hemisphere(
                        rng.uniform_float(key_sss, 104),
                        rng.uniform_float(key_sss, 105))
                    wi_sss = bx.to_world(te, be_, ne, wi_le)
                    pdf_sss = (wi_le[..., 2] / math.pi).clamp_min(1e-9)
                    f_cont = sw_lobe(eta1, c_norm, wi_le[..., 2])
                    # thru at the exit = w_prof * Sw * cos / pdf
                    thru_sss = spec(w_prof) * (f_cont * wi_le[..., 2]
                                               / pdf_sss)[..., None]
                    wi_w = torch.where(entered[..., None], wi_sss, wi_w)
                    thru = torch.where(entered[..., None],
                                       torch.where(ok_sss[..., None],
                                                   thru * thru_sss, 0.0),
                                       thru)
                    spawn_p = torch.where(entered[..., None], pe, spawn_p)
                    spawn_ng = torch.where(entered[..., None], ne, spawn_ng)
                    bs_specular = torch.where(entered, False, bs_specular)
                    bs_pdf = torch.where(entered, pdf_sss, bs_pdf)
                    ok = ok & (~entered | ok_sss)

            with tlog.annotate("continue"):
                beta = beta * torch.where(
                    (ok & alive)[..., None], thru,
                    torch.where(alive[..., None], 0.0, 1.0))
                alive = alive & ok & (torch.amax(beta, -1) > 0.0)
                eta_scale = eta_scale * torch.where(alive, bs.eta_scale, 1.0)
                prev_specular = torch.where(alive, bs_specular,
                                            prev_specular)
                prev_pdf = torch.where(alive, bs_pdf.clamp_min(1e-12),
                                       prev_pdf)
                prev_p = torch.where(alive[..., None], spawn_p, prev_p)

                # ---- spawn next ray ----
                o = torch.where(alive[..., None],
                                offset_ray_origin(spawn_p, spawn_ng, wi_w), o)
                d = torch.where(alive[..., None], wi_w, d)

                # ---- russian roulette (path.cpp:193-199) ----
                rr_beta = torch.amax(beta * eta_scale[..., None], -1)
                q = (1.0 - rr_beta).clamp_min(0.05)
                do_rr = ((rr_beta < rr_threshold) & alive
                         & (bounce >= _RR_START))
                die = do_rr & (ub[6] < q)
                alive = alive & ~die
                denom = torch.where(do_rr & ~die, (1.0 - q).clamp_min(1e-6),
                                    1.0)
                beta = torch.where(die[..., None], 0.0,
                                   beta / denom[..., None])

    aov = torch.stack([aov_nodes.to(torch.float32),
                       aov_leaves.to(torch.float32),
                       aov_tests.to(torch.float32),
                       path_len.to(torch.float32)], -1)
    if n_chan != 3:
        L = sampled_to_rgb(L)
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
    `upload` (the parity tests hand over the JAX package's tables).

    A scene whose accelerator is not `bvh` renders through a kd-tree
    (`kdtree`), a restricted BSP (`rbsp`, "integer nbDirections" 3-13) or one
    of the unrestricted-BSP family (`bsp...`), built here by the native
    builders unless `tables` already carry one. `accel_stats` describes the
    tree; `accel_nodes` / `accel_dirs` hold a tree built here as numpy
    arrays for `accel.kdbsp.dump_tree` and `node_type_depth_maps`. A tree too
    deep for the traversal stack raises.

    `isect(ds, st, o, d, tmax, any_hit=False, with_stats=True)` replaces the
    traversal `pick_traversal` picks. collect_stats (False by default, as in
    the JAX package) is handed to the traversal's `with_stats`: without it
    the kernels leave the per-ray counters (the node-visit, leaf-visit and
    prim-test AOVs) out; the images are the same either way.

    Integrators: `path`; `volpath`, which renders a scene with media
    through integrators/volpath.py (`volpath_li`) and one without through
    `path_li`, as the JAX package does; `directlighting`, `whitted` and
    `ambientocclusion` (integrators/direct.py); `bdpt`
    (integrators/bdpt.py, its t == 1 strategies into the film's splats,
    which `image` scales by 1 / the samples accumulated into the film).
    `mlt` and `sppm` render through their drivers, integrators/mlt.py
    `MLTRenderer(renderer)` and sppm.py `SPPMRenderer(renderer)`; inside
    this sample loop they, and any other name, estimate with `path_li`, as
    the JAX package's step does. `value_and_grad` and the training step
    take every one of them (GRADIENT_INTEGRATORS).
    spectral=True renders with 60-bin sampled-spectrum transport
    (`upload(spectral=True)`; tables handed over are switched to it); an
    integrator outside the spectral families warns and renders in RGB."""

    def __init__(self, scene: FlatScene, device="cuda",
                 light_strategy: str = None, tables=None, isect=None,
                 collect_stats: bool = False, spectral: bool = False):
        name = scene.integrator.name
        if spectral and name not in SPECTRAL_INTEGRATORS:
            warnings.warn("spectral transport covers the path/volpath/bdpt/"
                          f"mlt integrator families; {name} renders in RGB")
            spectral = False
        accel = (scene.accelerator_name or "bvh").lower()
        self.device = torch.device(device)
        self.scene = scene
        strategy = light_strategy or scene.integrator.light_strategy
        t0 = _time.time()
        with tlog.annotate("upload"):
            self.ds, self.st = tables or upload(
                scene, light_strategy=strategy, device=self.device,
                spectral=spectral)
            if spectral:
                self.st = self.st._replace(n_channels=N_SPECTRAL_SAMPLES)
            alt = accel not in ("bvh", "bvhold")
            if alt:
                self._set_alt_accel(accel)
            else:
                self.accel_stats = {"kind": "bvh", "n_nodes": self.st.n_nodes}
        self.upload_seconds = _time.time() - t0
        self.sampler = WavefrontSampler(
            scene.sampler.name, scene.film.xres, scene.film.yres,
            scene.sampler.spp, scene.sampler.seed)
        self.cfg = scene.film
        self._isect = isect or pick_traversal(self.st, alt)
        self.collect_stats = collect_stats
        self._shade_tables = (tri_shade_table(self.ds),
                              sph_shade_table(self.ds))
        # exit-pupil bounds of the realistic camera (BoundExitPupil,
        # realistic.cpp:231: sampling the whole rear element wastes most
        # lanes to vignetting), built once; a caller may replace them
        self.pupil = None
        cam = scene.camera
        if cam.lens_data is not None:
            self.pupil = torch.from_numpy(bound_exit_pupil(
                cam.lens_data, cam.lens_z, cam.film_diag)).to(self.device)

        # the first medium's parameters, for tools that inspect one medium
        self._medium = (build_medium(next(iter(scene.media.values())), scene)
                        if scene.media else None)

        # the crop window's pixels in tile order, (px, py) int32 arrays
        self._pixels = _pixel_order(self.cfg)
        self.n_pixels = len(self._pixels[0])
        # fixed-size wavefront batches; the tail is padded and masked
        self.set_batch(min(BATCH_RAYS, 1 << int(np.ceil(np.log2(
            max(self.n_pixels, 1024))))))
        self._spp_rendered = 0

    def set_batch(self, batch: int):
        """Cut the crop window's pixels into wavefront batches of `batch`
        lanes, the tail padded with masked lanes. A lane's value does not
        depend on its batch; the sharded renderer cuts smaller batches so
        that every rank has one."""
        pxf, pyf = self._pixels
        self.batch = int(batch)
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

    def _set_alt_accel(self, accel: str):
        """The thesis kd / RBSP / BSP family (research-parity path): build the
        tree, and keep it for the tree tools, unless the tables carry one."""
        if self.st.alt_tree_depth > 0:
            leaf = self.ds.alt_nodes.view(torch.int32)[:, 4] == 1
            self.accel_stats = dict(
                kind=accel, n_nodes=leaf.shape[0],
                max_leaf=self.st.alt_max_leaf, n_leaves=int(leaf.sum()),
                tree_depth=self.st.alt_tree_depth)
            return
        nodes, dirs, _, astats = kdbsp.build_alt_accel(
            self.scene, accel, self.scene.accelerator_params)
        self.ds, self.st = with_alt_accel(self.ds, self.st, nodes, dirs)
        self.accel_stats = {"kind": accel, **astats}
        self.accel_nodes, self.accel_dirs = nodes, dirs

    def _radiance(self, ds, sample_idx, b, isect=None, tables=None,
                  with_stats=None):
        """(p_raster, L, aov) of batch `b`: camera rays, from the camera
        matrices of `ds` (differentiable with respect to them) -> path_li ->
        each ray's radiance as the film takes it, before the film's
        max_sample_luminance: bad samples black, and under the realistic
        camera vignetted rays black and the rest scaled by the exit-pupil
        weight. The render and the training step both take this L."""
        cam, sampler, st = self.scene.camera, self.sampler, self.st
        px_b, py_b = self._px_b[b], self._py_b[b]
        with tlog.annotate("camera"):
            jx, jy = sampler.camera_jitter(px_b, py_b, sample_idx)
            p_raster = torch.stack([px_b.to(torch.float32) + jx,
                                    py_b.to(torch.float32) + jy], -1)
            ul1 = sampler.dim(px_b, py_b, sample_idx, 2)
            ul2 = sampler.dim(px_b, py_b, sample_idx, 3)
            # the ray's shutter time (CameraSample::time, camera.h:67),
            # normalised to [0,1]: drawn only where something moves
            time = (sampler.dim(px_b, py_b, sample_idx, 4)
                    if st.has_motion or st.cam_animated else None)
            lens = None
            if cam.lens_data is not None:
                o, d, alive, weight = realistic_rays(
                    cam.lens_data, cam.lens_z, ds.cam_to_world, p_raster,
                    torch.stack([ul1, ul2], -1), self.cfg.xres,
                    self.cfg.yres, cam.film_diag, pupil=self.pupil)
                lens = (alive, weight)
            else:
                keys = (dict(cam_q=ds.cam_q, cam_tr=ds.cam_tr, time=time)
                        if st.cam_animated else {})
                o, d = generate_rays(cam.type, ds.raster_to_camera,
                                     ds.cam_to_world, p_raster,
                                     torch.stack([ul1, ul2], -1),
                                     cam.lens_radius, cam.focal_distance,
                                     self.cfg.xres, self.cfg.yres, **keys)
        integ = self.scene.integrator
        name = integ.name
        kw = dict(isect=isect or self._isect,
                  tables=tables or self._shade_tables,
                  with_stats=(self.collect_stats if with_stats is None
                              else with_stats))
        splats = None
        if name == "volpath" and st.n_media > 0:
            from tpupt_torch.integrators.volpath import volpath_li

            L, aov = volpath_li(ds, st, sampler, integ.max_depth,
                                integ.rr_threshold, px_b, py_b, sample_idx,
                                o, d, **kw)
        elif name == "bdpt":
            from tpupt_torch.integrators.bdpt import bdpt_li

            L, aov, sp_p, sp_L = bdpt_li(
                ds, st, sampler, integ.max_depth, px_b, py_b, sample_idx,
                o, d, self.cfg.xres, self.cfg.yres, valid=self._valid_b[b],
                **kw)
            splats = (sp_p, sp_L)
        elif name in ("directlighting", "whitted"):
            from tpupt_torch.integrators.direct import direct_lighting_li

            strategy = integ.strategy if name == "directlighting" else "all"
            L, aov = direct_lighting_li(ds, st, sampler, integ.max_depth,
                                        strategy, px_b, py_b, sample_idx, o,
                                        d, **kw)
        elif name == "ambientocclusion":
            from tpupt_torch.integrators.direct import ao_li

            L, aov = ao_li(ds, st, sampler, min(integ.n_ao_samples, 16),
                           integ.cos_sample, px_b, py_b, sample_idx, o, d,
                           **kw)
        else:
            # path, volpath without media, and any other name (mlt and
            # sppm inside the shared sample loop), as the JAX package's
            # step does
            with tlog.annotate("path_li"):
                L, aov = path_li(ds, st, sampler, integ.max_depth,
                                 integ.rr_threshold, px_b, py_b, sample_idx,
                                 o, d, time=time, **kw)
        # NaN/inf clamping to black (integrator.cpp:300-321): the reference
        # kills samples with NEGATIVE LUMINANCE (y < -1e-5), not per-channel
        # negatives
        bad = ~torch.isfinite(L).all(-1) | (luminance(L) < -1e-5)
        L = torch.where(bad[..., None], 0.0, L)
        if lens is not None:
            # vignetted lanes carry nothing; the exit-pupil box's measure
            # turns the estimate into one over the rear disk
            L = torch.where(lens[0][..., None], L, 0.0) * lens[1][..., None]
        if splats is not None:
            return p_raster, L, aov, splats
        return p_raster, L, aov

    def _step(self, film, sample_idx, b, ds=None, **kw):
        """One batch of one sample: camera rays -> the integrator -> film
        (BDPT's t == 1 strategies into its splats). `ds` replaces the
        renderer's tables, `kw` goes to `_radiance`. A `render.batch` span
        (count: `b`) holding `camera`, `path_li` and `film`."""
        with tlog.annotate("render.batch", count=b):
            p_raster, L, aov, *splats = self._radiance(
                self.ds if ds is None else ds, sample_idx, b, **kw)
            with tlog.annotate("film"):
                if splats:
                    film = filmmod.add_splats(film, self.cfg, *splats[0])
                cap = self.cfg.max_sample_luminance
                if np.isfinite(cap):
                    lum = luminance(L)
                    s = torch.where(lum > cap, cap / lum.clamp_min(1e-9),
                                    1.0)
                    L = L * s[..., None]
                return filmmod.add_samples(film, self.cfg, p_raster, L, aov,
                                           mask=self._valid_b[b])

    @torch.no_grad()
    def _spp(self, film, sample_idx: int):
        """One full sample over every batch: a `render.sample` span (unit:
        the sample index; count: the batches)."""
        sample_idx = int(sample_idx)
        with tlog.annotate("render.sample", unit=sample_idx,
                           count=self.n_batches):
            for b in range(self.n_batches):
                film = self._step(film, sample_idx, b)
            return film

    def value_and_grad(self, loss, params: dict, sample_idx: int = 0):
        """(value, grads, film): `loss` of the film of one full sample (every
        batch) and its gradients with respect to `params`, the counterpart of
        `jax.value_and_grad(loss)` over the JAX package's film step.

        `params` maps DeviceScene field names (`mat_kd`, `mat_ks`,
        `mat_roughness`, `light_L`, `raster_to_camera`, `cam_to_world`, ...)
        to tensors that replace the renderer's tables; `grads` maps the same
        names to tensors of the same shapes. `loss(film) -> scalar tensor`
        reads the `Film` (`sum(film.rgb)` is what the bench differentiates);
        the gradients reach it through `film.rgb` and, under BDPT, through
        the t == 1 strategies' `film.splat`. `film` is the sample's film,
        the same as `render` gives for this sample. Every integrator
        `Renderer` renders is differentiated, and every float table of the
        DeviceScene, the medium tables (`med_sigma_a`, `med_sigma_s`,
        `med_g`, `med_majorant`, `med_density`, `med_w2m`) included: a grid
        medium's transmittance through K6's backward
        (ops/media_tracking.py).

        Traversal is detached (the detached-sampling estimator). Pass 1
        renders every batch without autograd and with the counters off,
        recording each traversal's hits (integrators/replay.py), and takes
        `dloss/dfilm.rgb` and `dloss/dfilm.splat` on the film alone. Pass 2
        replays each batch's shading chain with autograd on, over the
        recorded hits, and back-propagates the film cotangents (K6, which
        is not traversal, runs again, its backward with it); each batch's
        graph is freed
        before the next is built. So the traversal kernels launch as often as
        in a forward sample, and memory holds one batch's graph and the
        recorded hits (about 30 B a ray a traversal).

        Spans: `grad.step` (unit: `sample_idx`) holding `grad.pass1` (its
        batches' `render.batch`), `grad.loss` (the loss and its cotangent)
        and `grad.pass2`, which holds a `grad.replay` (the batch's forward
        under autograd) and a `grad.backward` (`torch.autograd.backward`,
        whose kernels autograd's device thread launches) a batch."""
        unknown = sorted(set(params) - set(DeviceScene._fields))
        if unknown:
            raise KeyError(f"not fields of DeviceScene: {unknown}")
        sample_idx = int(sample_idx)
        with tlog.annotate("grad.step", unit=sample_idx):
            leaves = {k: v.detach().to(self.device).requires_grad_()
                      for k, v in params.items()}
            fixed = self.ds._replace(**{k: v.detach()
                                        for k, v in leaves.items()})
            rec = HitRecorder(self._isect)
            with torch.no_grad(), tlog.annotate("grad.pass1"):
                tables = (tri_shade_table(fixed), sph_shade_table(fixed))
                film = self.new_film()
                for b in range(self.n_batches):
                    film = self._step(film, sample_idx, b, ds=fixed,
                                      isect=rec.record, tables=tables,
                                      with_stats=False)
            films = {f: getattr(film, f).detach().requires_grad_()
                     for f in ("rgb", "splat")}
            with torch.enable_grad(), tlog.annotate("grad.loss"):
                value = loss(film._replace(**films))
                cot = (torch.autograd.grad(value, list(films.values()),
                                           allow_unused=True)
                       if value.requires_grad else (None, None))
            cot = {f: g for f, g in zip(films, cot) if g is not None}
            if cot:
                replay = rec.replay()
                ds = self.ds._replace(**leaves)
                with torch.enable_grad(), tlog.annotate("grad.pass2"):
                    tables = (tri_shade_table(ds), sph_shade_table(ds))
                    for b in range(self.n_batches):
                        with tlog.annotate("grad.replay"):
                            fb = self._step(self.new_film(), sample_idx, b,
                                            ds=ds, isect=replay,
                                            tables=tables, with_stats=False)
                        outs = [(getattr(fb, f), g) for f, g in cot.items()
                                if getattr(fb, f).requires_grad]
                        if outs:
                            with tlog.annotate("grad.backward"):
                                torch.autograd.backward(
                                    [x for x, _ in outs],
                                    [g for _, g in outs],
                                    inputs=list(leaves.values()))
                        del fb, outs
                replay.finish()
            grads = {k: (v.grad if v.grad is not None
                         else torch.zeros_like(v))
                     for k, v in leaves.items()}
            return value.detach(), grads, film

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

    def save_checkpoint(self, film, path: str, sample_done: int):
        """Film snapshot for resumable renders (the reference has none): an
        .npz of the film's rgb, weight, splat and aov and `sample_done`."""
        np.savez(path, rgb=film.rgb.cpu().numpy(),
                 weight=film.weight.cpu().numpy(),
                 splat=film.splat.cpu().numpy(), aov=film.aov.cpu().numpy(),
                 sample_done=sample_done)

    def load_checkpoint(self, path: str):
        """(film on this renderer's device, next sample index)."""
        z = np.load(path)
        film = filmmod.Film(**{k: torch.from_numpy(z[k]).to(self.device)
                               for k in filmmod.Film._fields})
        return film, int(z["sample_done"])

    def render_resumable(self, spp: int = None, checkpoint: str = None,
                         every: int = 4, verbose: bool = False):
        """`render` with a film checkpoint written after every `every`
        samples; resumes from `checkpoint` when that file exists."""
        spp = spp or self.scene.sampler.spp
        film, start = (self.load_checkpoint(checkpoint)
                       if checkpoint and os.path.exists(checkpoint)
                       else (self.new_film(), 0))
        for s in range(start, spp):
            film = self._spp(film, s)
            if checkpoint and (s + 1) % every == 0:
                self.save_checkpoint(film, checkpoint, s + 1)
            if verbose:
                print(f"  sample {s + 1}/{spp}", flush=True)
        self._spp_rendered = spp
        return film

    def image(self, film):
        # splats (BDPT t == 1) are averaged over the samples accumulated
        # into this film (Film::WriteImage splatScale, film.cpp:153)
        scale = 1.0 / max(self._spp_rendered, 1)
        return filmmod.to_image(film, self.cfg, scale).cpu().numpy()

    def aovs(self, film):
        return {k: v.cpu().numpy()
                for k, v in filmmod.aov_images(film, self.cfg).items()}
