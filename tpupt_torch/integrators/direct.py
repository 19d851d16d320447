"""Direct lighting, Whitted, and ambient-occlusion integrators.

Counterparts of src/integrators/{directlighting,whitted,ao}.cpp, expressed as
wavefront passes on the same traversal and shading machinery as the path
integrator; `Renderer._radiance` dispatches to them. Every traversal goes
through the renderer's traversal wrapper (`isect`, detached as in
`path_li`): K1, K2 or K3 on the card, the plain walkers on the CPU."""

from __future__ import annotations

import math

import torch

from tpupt_torch.core import rng
from tpupt_torch.core.sampling import (cosine_sample_hemisphere,
                                       power_heuristic,
                                       uniform_sample_hemisphere)
from tpupt_torch.core.spectrum import sampled_to_rgb
from tpupt_torch.core.vecmath import absdot, offset_ray_origin
from tpupt_torch.integrators.path import (_infinite_light_le,
                                          detached_traversal,
                                          miss_radiance_and_pdf,
                                          pick_traversal, shading_point,
                                          sph_shade_table, tri_shade_table,
                                          uplift)
from tpupt_torch.lights.lights import emitted_radiance, pdf_li, sample_li
from tpupt_torch.materials import bsdf as bx


def _setup(ds, st, isect, tables, with_stats):
    isect = isect or pick_traversal(st)
    tables = tables or (tri_shade_table(ds), sph_shade_table(ds))
    return detached_traversal(isect, ds, st, with_stats), tables


def direct_lighting_li(ds, st, sampler, max_depth, strategy,
                       px, py, sample_idx, o, d, isect=None, tables=None,
                       with_stats=True):
    """DirectLightingIntegrator::Li (directlighting.cpp:50): emitted light
    + NEE at each vertex (strategy "all": every light; "one": one light
    picked uniformly) with both halves of EstimateDirect, recursion through
    specular surfaces only (depth-limited, an unrolled specular chase).
    Each vertex: one closest hit, and per light one shadow ray and one
    BSDF-sampled ray. Returns (L (N,3), aov zeros (N,4))."""
    intersect, tables = _setup(ds, st, isect, tables, with_stats)
    spec = uplift(st)
    n = o.shape[0]
    n_chan = st.n_channels
    feats = st.mat_features
    L = o.new_zeros((n, n_chan))
    beta = o.new_ones((n, n_chan))
    alive = torch.ones(n, dtype=torch.bool, device=o.device)

    for depth in range(max_depth):
        base = 5 + depth * 7
        hit, _ = intersect(o, d, o.new_full((n,), math.inf))
        sp = shading_point(ds, st, hit, o, d, tables)
        wo = -d

        if st.n_lights > 0:
            le = emitted_radiance(ds, st, hit.prim, sp.light, wo, sp.ns)
            L = L + torch.where((alive & hit.valid)[..., None],
                                beta * spec(le), 0.0)
            inf_le = _infinite_light_le(ds, st).expand(n, 3)
            L = L + torch.where((alive & ~hit.valid)[..., None],
                                beta * spec(inf_le), 0.0)
        alive = alive & hit.valid

        mp = bx.gather_mat_params(ds, sp.mat, uv=sp.uv, p=sp.p, face=sp.face,
                                  has_textures=st.has_textures,
                                  tex_types=st.tex_types,
                                  has_mix="mix" in feats,
                                  fourier_meta=st.fourier)
        t_f, b_f, n_f = bx.make_frame(sp.ns)
        wo_l = bx.to_local(t_f, b_f, n_f, wo)

        if st.n_lights > 0:
            light_ids = range(st.n_lights) if strategy == "all" else [None]
            for li_idx in light_ids:
                k = li_idx or 0
                if li_idx is None:
                    u_l = sampler.dim(px, py, sample_idx, base + 0)
                    lid = (u_l * st.n_lights).to(torch.int32).clamp(
                        0, st.n_lights - 1)
                    pmf = 1.0 / st.n_lights
                else:
                    lid = torch.full((n,), li_idx, dtype=torch.int32,
                                     device=o.device)
                    pmf = 1.0
                u1 = sampler.dim(px, py, sample_idx, base + 1 + 2 * k)
                u2 = sampler.dim(px, py, sample_idx, base + 2 + 2 * k)
                ls = sample_li(ds, st, lid, sp.p, u1, u2)
                wi_l = bx.to_local(t_f, b_f, n_f, ls.wi)
                f_l, pdf_b = bx.eval_pdf(mp, wo_l, wi_l, feats,
                                         st.mix_features)
                f_l = f_l * absdot(ls.wi, sp.ns)[..., None]
                can = alive & (ls.pdf > 0.0) & (torch.amax(f_l, -1) > 0.0)
                o_sh = offset_ray_origin(sp.p, sp.ng, ls.wi)
                occ = intersect(o_sh, ls.wi,
                                torch.where(can, ls.dist * 0.999, 0.0),
                                any_hit=True)[0].valid
                w_l = torch.where(ls.is_delta, 1.0,
                                  power_heuristic(1.0, ls.pdf, 1.0, pdf_b))
                contrib = beta * spec(f_l) * spec(ls.li) * (
                    w_l / (ls.pdf * pmf).clamp_min(1e-12))[..., None]
                L = L + torch.where((can & ~occ)[..., None], contrib, 0.0)

                # the BSDF-sampled half of EstimateDirect toward the SAME
                # light (integrator.cpp:163-215): without it the MIS weight
                # above loses the area-light energy this strategy carries
                key = rng.uniform_u32(px, py, sample_idx)
                key = rng.hash_combine(key, 900 + depth * 16 + k)
                bs_d = bx.sample(mp, wo_l, rng.uniform_float(key, 0),
                                 rng.uniform_float(key, 1),
                                 rng.uniform_float(key, 2), feats,
                                 st.mix_features)
                wi_bw = bx.to_world(t_f, b_f, n_f, bs_d.wi)
                can_b = (alive & ~ls.is_delta & ~bs_d.specular
                         & (bs_d.pdf > 1e-9) & (torch.amax(bs_d.f, -1) > 0.0))
                o_b = offset_ray_origin(sp.p, sp.ng, wi_bw)
                hit2, _ = intersect(o_b, wi_bw,
                                    torch.where(can_b, math.inf, 0.0))
                sp2 = shading_point(ds, st, hit2, o_b, wi_bw, tables)
                # the chosen light's geometry hit?
                hit_light = hit2.valid & (sp2.light == lid)
                le2 = emitted_radiance(ds, st, hit2.prim, sp2.light, -wi_bw,
                                       sp2.ns)
                t_safe = torch.where(hit2.valid, hit2.t, 1.0)
                lp2 = pdf_li(ds, st, sp.p, wi_bw, hit2.prim.clamp_min(0),
                             t_safe)
                # an escaped ray toward the env light
                miss_le, miss_pdf = miss_radiance_and_pdf(ds, st, wi_bw)
                is_env = (st.env_light_id >= 0) & (lid == st.env_light_id)
                le_b = torch.where(
                    hit_light[..., None], le2,
                    torch.where((~hit2.valid & is_env)[..., None], miss_le,
                                0.0))
                lp_b = torch.where(hit_light, lp2,
                                   torch.where(~hit2.valid & is_env,
                                               miss_pdf, 0.0))
                w_b = power_heuristic(1.0, bs_d.pdf, 1.0, lp_b)
                contrib_b = beta * spec(bs_d.f) * spec(le_b) * (
                    absdot(wi_bw, sp.ns) * w_b
                    / (bs_d.pdf * pmf).clamp_min(1e-12))[..., None]
                L = L + torch.where(can_b[..., None], contrib_b, 0.0)

        # specular continuation only (whitted-style)
        u_lobe = sampler.dim(px, py, sample_idx, base + 5)
        ub1 = sampler.dim(px, py, sample_idx, base + 6)
        bs = bx.sample(mp, wo_l, u_lobe, ub1, ub1, feats, st.mix_features)
        specular = bs.specular & alive
        wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
        thru = spec(bs.f) * (absdot(wi_w, sp.ns)
                             / bs.pdf.clamp_min(1e-9))[..., None]
        beta = torch.where(specular[..., None], beta * thru, beta)
        alive = specular & (bs.pdf > 1e-9)
        o = offset_ray_origin(sp.p, sp.ng, wi_w)
        d = wi_w

    if n_chan != 3:
        L = sampled_to_rgb(L)
    return L, L.new_zeros((n, 4))


def whitted_li(ds, st, sampler, max_depth, px, py, sample_idx, o, d,
               **kw):
    """WhittedIntegrator::Li (whitted.cpp:49): direct lighting from every
    light + perfect specular reflection / transmission recursion."""
    return direct_lighting_li(ds, st, sampler, max_depth, "all",
                              px, py, sample_idx, o, d, **kw)


def ao_li(ds, st, sampler, n_samples, cos_sample, px, py, sample_idx, o, d,
          isect=None, tables=None, with_stats=True, max_dist=None):
    """AOIntegrator::Li (ao.cpp:52): cosine- or uniform-sampled hemisphere
    occlusion at the first hit: one closest hit and `n_samples` any-hit
    rays. Returns (L (N,3), aov zeros (N,4))."""
    intersect, tables = _setup(ds, st, isect, tables, with_stats)
    n = o.shape[0]
    hit, _ = intersect(o, d, o.new_full((n,), math.inf))
    sp = shading_point(ds, st, hit, o, d, tables)
    t_f, b_f, n_f = bx.make_frame(sp.ns)
    wo_l = bx.to_local(t_f, b_f, n_f, -d)
    # the frame flipped to the outgoing side (ao.cpp: n = Faceforward(n,
    # -ray.d))
    flip = wo_l[..., 2] < 0.0

    L = o.new_zeros(n)
    md = math.inf if max_dist is None else max_dist
    for k in range(n_samples):
        u1 = sampler.dim(px, py, sample_idx, 5 + 2 * k)
        u2 = sampler.dim(px, py, sample_idx, 6 + 2 * k)
        if cos_sample:
            wi_l = cosine_sample_hemisphere(u1, u2)
            pdf = wi_l[..., 2] / math.pi
        else:
            wi_l = uniform_sample_hemisphere(u1, u2)
            pdf = o.new_full((n,), 1.0 / (2.0 * math.pi))
        wi_l = wi_l * torch.stack([o.new_ones(n), o.new_ones(n),
                                   torch.where(flip, -1.0, 1.0)], -1)
        wi_w = bx.to_world(t_f, b_f, n_f, wi_l)
        o_sh = offset_ray_origin(sp.p, sp.ng, wi_w)
        occ = intersect(o_sh, wi_w,
                        torch.where(hit.valid, o.new_full((n,), md), 0.0),
                        any_hit=True)[0].valid
        vis = hit.valid & ~occ & (pdf > 0)
        L = L + torch.where(
            vis, torch.abs(wi_l[..., 2]) / (pdf * n_samples).clamp_min(1e-9),
            0.0)
    return L[..., None].repeat(1, 3), L.new_zeros((n, 4))
