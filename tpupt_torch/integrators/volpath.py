"""Volumetric path integrator (counterpart of src/integrators/volpath.cpp;
the JAX package's integrators/volpath.py), with per-interface media:

- every prim carries a MediumInterface (DeviceScene prim_med_in / out) and
  every ray lane its current medium id (-1 = vacuum);
- distance sampling runs against the lane's medium (media/media.py
  `sample_distance_lane`); vacuum lanes never interact;
- a hit on an interface-only prim (Material "none") passes through without
  using up a path vertex, switching the lane's medium at a transition;
- refraction through a transition prim switches the medium by the crossing
  direction (entering = wi against the raw geometric normal);
- an NEE shadow ray gathers transmittance across up to 4 null interfaces
  (Scene::IntersectTr, scene.cpp:57-73) through closest-hit traversals when
  the scene has interfaces, else one any-hit traversal; a lane still
  crossing after the budget counts as occluded;
- the loop runs max_depth + 1 + extra iterations (extra = 4 with
  interfaces) with a per-lane real-vertex counter, so that sampler
  dimensions and Russian roulette stay aligned with path_li's.

Medium decisions hash counters (core/rng.py) instead of drawing sampler
dimensions, so the sampler's dimension layout is path_li's. In spectral
transport the medium tables are uplifted once, so Beer-Lambert
exponentiates per bin. Grid-medium tracking runs in kernel K6 on the card
(ops/media_tracking.py), its transmittance's gradient in K6's backward.
Every medium table and every lane's origin and direction reach
`tr_lane` / `sample_distance_lane` with their gradients, as in jax.grad of
the JAX package's volpath; only the traversal's inputs are detached.
"""

from __future__ import annotations

import math

import torch

from tpupt_torch.core import rng
from tpupt_torch.core.rng import as_u32
from tpupt_torch.core.sampling import power_heuristic
from tpupt_torch.core.spectrum import sampled_to_rgb
from tpupt_torch.core.vecmath import (absdot, coordinate_system, cross, dot,
                                      normalize, offset_ray_origin)
from tpupt_torch.integrators.path import (_RR_START, detached_traversal,
                                          miss_radiance_and_pdf,
                                          pick_traversal, shading_point,
                                          sph_shade_table, tri_shade_table,
                                          uplift)
from tpupt_torch.lights.lights import emitted_radiance, pdf_li, sample_li
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.media.media import (hg_phase, media_view,
                                     sample_distance_lane, tr_lane)

# null-interface crossings a shadow ray may make, and extra loop iterations
# for camera paths, when the scene has medium interfaces
SHADOW_SEGMENTS, EXTRA_DEPTH = 4, 4


def _raw_gn(ds, st, prim, p):
    """The raw geometric normal (winding and orientation baked in): it
    defines the inside / outside of a MediumInterface (medium.h)."""
    pr = prim.clamp_min(0)
    is_tri = pr < st.n_tris
    tid = pr.clamp(0, max(st.n_tris - 1, 0)).long()
    gn_t = cross(ds.tri_p1[tid] - ds.tri_p0[tid],
                 ds.tri_p2[tid] - ds.tri_p0[tid])
    sid = (pr - st.n_tris).clamp(0, max(st.n_spheres - 1, 0)).long()
    center = ds.sph_o2w[sid][:, :3, 3]
    gn_s = (p - center) * torch.where(ds.sph_reverse[sid].bool(), -1.0,
                                      1.0)[..., None]
    return normalize(torch.where(is_tri[..., None], gn_t, gn_s))


def _prim_mat(ds, st, prim):
    pr = prim.clamp_min(0)
    tid = pr.clamp(0, max(st.n_tris - 1, 0)).long()
    sid = (pr - st.n_tris).clamp(0, max(st.n_spheres - 1, 0)).long()
    return torch.where(pr < st.n_tris, ds.tri_mat[tid], ds.sph_mat[sid])


def _hg_sample_lane(axis, u1, u2, g):
    """HG sampling with a per-lane g (medium.cpp Sample_p), branch-free."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1e-3, g)
    sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * u1)
    cos_g = (1.0 + g * g - sq * sq) / (2.0 * g_safe)
    cos_t = torch.where(small, 1.0 - 2.0 * u1, cos_g.clamp(-1.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u2
    t, b = coordinate_system(axis)
    wi = ((sin_t * torch.cos(phi))[..., None] * t
          + (sin_t * torch.sin(phi))[..., None] * b + cos_t[..., None] * axis)
    return wi, hg_phase(-cos_t, g)


def _medium_across(ds, prim, gn, w):
    """The medium on the far side of prim's interface for direction w
    (entering when w runs against the raw normal gn), and whether the
    interface is a transition (inside != outside)."""
    pr = prim.clamp_min(0).clamp_max(ds.prim_med_in.shape[0] - 1).long()
    m_in, m_out = ds.prim_med_in[pr], ds.prim_med_out[pr]
    return torch.where(dot(w, gn) < 0.0, m_in, m_out), m_in != m_out


def volpath_li(ds, st, sampler, max_depth: int, rr_threshold: float,
               px, py, sample_idx, o, d, isect=None, tables=None,
               with_stats: bool = True):
    """Trace a camera-ray batch through the scene's media and surfaces.
    `isect` and `tables` as for path_li (every traversal goes through
    `isect`, detached; the counters are not gathered). Returns (L (N,3),
    aov (N,4): zeros but the path length)."""
    if isect is None:
        isect = pick_traversal(st)
    if tables is None:
        tables = (tri_shade_table(ds), sph_shade_table(ds))
    intersect = detached_traversal(isect, ds, st, with_stats)
    spec = uplift(st)
    n_chan = st.n_channels
    mt = media_view(ds)
    if n_chan != 3:
        mt = mt._replace(sigma_a=spec(mt.sigma_a), sigma_s=spec(mt.sigma_s))
    any_grid = st.any_grid_media
    has_ifaces = st.has_med_interfaces
    extra_depth = EXTRA_DEPTH if has_ifaces else 0
    segments = SHADOW_SEGMENTS if has_ifaces else 1
    feats = st.mat_features

    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    # the sampler's dimensions of each real vertex, (D, 7, N)
    u_all = (torch.stack([torch.stack([
        sampler.dim(px, py, sample_idx, 5 + b * 7 + k) for k in range(7)])
        for b in range(max_depth)]) if max_depth > 0
        else o.new_zeros((1, 7, n)))
    n_dims = u_all.shape[0]
    light_cdf = torch.cumsum(ds.light_pdf, 0)
    inf_pmf = 1.0 / max(st.n_lights, 1)
    tmax_init = o.new_full((n,), math.inf)
    pix_key = rng.uniform_u32(as_u32(px), as_u32(py), sample_idx)

    def shadow_tr(p_from, wi, dist, can, med0, keys):
        """IntersectTr (scene.cpp:57-73): occlusion and the transmittance
        gathered across up to `segments` - 1 null-interface crossings."""
        if segments == 1:
            occ = intersect(p_from, wi, torch.where(can, dist * 0.999, 0.0),
                            any_hit=True)[0].valid
            return occ, tr_lane(mt, any_grid, med0, p_from, wi, dist,
                                rng.hash_combine(keys, 900))
        tr = o.new_ones((n, n_chan))
        occ = torch.zeros(n, dtype=torch.bool, device=dev)
        o_cur, med, active = p_from, med0, can
        rem = torch.where(can, dist, 0.0)
        for k in range(segments):
            hit_k, _ = intersect(o_cur, wi,
                                 torch.where(active, rem * 0.999, 0.0))
            seg = torch.where(hit_k.valid, hit_k.t, rem)
            tr = tr * torch.where(
                active[..., None],
                tr_lane(mt, any_grid, med, o_cur, wi, seg,
                        rng.hash_combine(keys, 900 + k)), 1.0)
            m_hit = _prim_mat(ds, st, hit_k.prim)
            is_null = hit_k.valid & (ds.mat_type[m_hit.long()] == bx.MAT_NONE)
            occ = occ | (active & hit_k.valid & ~is_null)
            p_hit = o_cur + hit_k.t[..., None] * wi
            gn = _raw_gn(ds, st, hit_k.prim, p_hit)
            across, trans = _medium_across(ds, hit_k.prim, gn, wi)
            cross_ = active & is_null
            med = torch.where(cross_ & trans, across, med)
            o_cur = torch.where(cross_[..., None],
                                offset_ray_origin(p_hit, gn, wi), o_cur)
            rem = torch.where(cross_, torch.clamp_min(rem - hit_k.t, 0.0),
                              rem)
            active = cross_ & ~occ
        # the crossing budget used up: counted as occluded
        return occ | active, tr

    L = o.new_zeros((n, n_chan))
    beta = o.new_ones((n, n_chan))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_specular = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = o.new_ones(n)
    prev_p = o
    path_len = torch.zeros(n, dtype=i32, device=dev)
    cur_med = torch.full((n,), st.camera_medium, dtype=i32, device=dev)
    vert = torch.zeros(n, dtype=i32, device=dev)

    for it in range(max_depth + 1 + extra_depth):
        is_last = vert >= max_depth   # a lane's final, emission-only vertex
        hit, _ = intersect(o, d, torch.where(alive, tmax_init, 0.0))
        path_len = path_len + alive.to(i32)
        key_b = rng.hash_combine(pix_key, it)

        # null interfaces: passed through, no vertex used up
        m_hit = _prim_mat(ds, st, hit.prim)
        is_null = alive & hit.valid & (ds.mat_type[m_hit.long()] == bx.MAT_NONE)

        # medium distance sampling against the lane's medium
        t_surf = torch.where(hit.valid, hit.t, 1e7)
        interacted, t_m, w_med = sample_distance_lane(
            mt, any_grid, cur_med, o, d, t_surf,
            rng.uniform_float(key_b, 11), key_b)
        interacted = interacted & alive & ~is_last
        beta = beta * torch.where(alive[..., None], w_med, 1.0)
        is_null = is_null & ~interacted

        sp = shading_point(ds, st, hit, o, d, tables)
        wo = -d
        # emission at every real surface hit (the final vertex's too); NEE
        # and scattering not at the final one (path.cpp:82)
        emit_surf = alive & hit.valid & ~interacted & ~is_null
        surf = emit_surf & ~is_last

        # emitted radiance at real surface vertices (volpath.cpp:92)
        if st.n_lights > 0:
            le = emitted_radiance(ds, st, hit.prim, sp.light, wo, sp.ns)
            le = torch.where(emit_surf[..., None], le, 0.0)
            t_safe = torch.where(hit.valid, hit.t, 1.0)
            lp = pdf_li(ds, st, prev_p, d, hit.prim.clamp_min(0), t_safe)
            lp = torch.where(hit.valid, lp, 0.0)
            lid0 = sp.light.clamp(0, max(st.n_lights - 1, 0))
            pmf0 = ds.light_pdf[lid0.long()]
            w = torch.where(prev_specular, 1.0,
                            power_heuristic(1.0, prev_pdf, 1.0, lp * pmf0))
            L = L + beta * spec(le) * w[..., None]
            miss = alive & ~hit.valid & ~interacted
            miss_le, miss_pdf = miss_radiance_and_pdf(ds, st, d)
            w_inf = torch.where(prev_specular, 1.0, power_heuristic(
                1.0, prev_pdf, 1.0, miss_pdf * inf_pmf))
            L = L + torch.where(miss[..., None],
                                beta * spec(miss_le) * w_inf[..., None], 0.0)

        alive = alive & (hit.valid | interacted) & ~(is_last & ~is_null)

        # the sampler's dimensions of each lane's real vertex
        vert_c = vert.clamp_max(n_dims - 1).long()
        ub = u_all.gather(0, vert_c[None, None, :].expand(1, 7, n))[0]
        p_m = o + t_m[..., None] * d
        p_vertex = torch.where(interacted[..., None], p_m, sp.p)
        g_lane = mt.g[cur_med.clamp_min(0).long()]

        mp = bx.gather_mat_params(ds, sp.mat, uv=sp.uv, p=sp.p, face=sp.face,
                                  has_textures=st.has_textures,
                                  tex_types=st.tex_types,
                                  has_mix="mix" in feats,
                                  fourier_meta=st.fourier)
        t_f, b_f, n_f = bx.make_frame(sp.ns)
        wo_l = bx.to_local(t_f, b_f, n_f, wo)

        # NEE at medium and real surface vertices
        if st.n_lights > 0:
            lid = torch.searchsorted(light_cdf, ub[0].contiguous(),
                                     right=True).clamp(
                0, st.n_lights - 1).to(i32)
            pmf = ds.light_pdf[lid.long()]
            ls = sample_li(ds, st, lid, p_vertex, ub[1], ub[2])
            wi_l = bx.to_local(t_f, b_f, n_f, ls.wi)
            f_s, pdf_b = bx.eval_pdf(mp, wo_l, wi_l, feats, st.mix_features)
            f_s = spec(f_s * absdot(ls.wi, sp.ns)[..., None])
            ph = hg_phase(dot(wo, ls.wi), g_lane)
            f_l = torch.where(interacted[..., None],
                              ph[..., None].expand(-1, n_chan), f_s)
            pdf_fwd = torch.where(interacted, ph, pdf_b)
            can = ((interacted | surf) & (ls.pdf > 0.0)
                   & (torch.amax(f_l, -1) > 0.0))
            o_sh = torch.where(interacted[..., None], p_m,
                               offset_ray_origin(sp.p, sp.ng, ls.wi))
            occ, tr = shadow_tr(o_sh, ls.wi, ls.dist, can, cur_med,
                                rng.hash_combine(key_b, 23))
            w_l = torch.where(ls.is_delta, 1.0, power_heuristic(
                1.0, ls.pdf * pmf, 1.0, pdf_fwd))
            contrib = beta * f_l * tr * spec(ls.li) * (
                w_l / (ls.pdf * pmf).clamp_min(1e-12))[..., None]
            L = L + torch.where((can & ~occ)[..., None], contrib, 0.0)

        # continuation: the BSDF at surfaces, the phase function in media,
        # straight on through null interfaces
        bs = bx.sample(mp, wo_l, ub[3], ub[4], ub[5], feats, st.mix_features)
        wi_surf = bx.to_world(t_f, b_f, n_f, bs.wi)
        cos_w = absdot(wi_surf, sp.ns)
        ok_s = bs.pdf > 1e-9
        thru_s = spec(bs.f) * (cos_w / bs.pdf.clamp_min(1e-9))[..., None]
        wi_med, ph_pdf = _hg_sample_lane(d, rng.uniform_float(key_b, 31),
                                         rng.uniform_float(key_b, 37), g_lane)
        wi_w = torch.where(interacted[..., None], wi_med,
                           torch.where(is_null[..., None], d, wi_surf))
        beta = beta * torch.where(
            (surf & ok_s)[..., None], thru_s,
            torch.where((surf & ~ok_s)[..., None], 0.0, 1.0))
        alive = (alive & (interacted | is_null | ok_s)
                 & (torch.amax(beta, -1) > 0.0))

        # medium transitions at interface crossings
        gn_raw = _raw_gn(ds, st, hit.prim, sp.p)
        across, is_trans = _medium_across(ds, hit.prim, gn_raw, wi_w)
        switch = (alive & hit.valid & ~interacted & is_trans
                  & (is_null | (dot(wi_w, gn_raw) * dot(wo, gn_raw) < 0.0)))
        cur_med = torch.where(switch, across, cur_med)

        vertex = surf | interacted
        prev_specular = torch.where(
            vertex, ~interacted & bs.specular, prev_specular)
        prev_pdf = torch.where(
            vertex, torch.where(interacted, ph_pdf.clamp_min(1e-12),
                                bs.pdf.clamp_min(1e-12)), prev_pdf)
        prev_p = torch.where(vertex[..., None], p_vertex, prev_p)
        o2 = torch.where(interacted[..., None], p_m,
                         torch.where(is_null[..., None],
                                     offset_ray_origin(sp.p, gn_raw, d),
                                     offset_ray_origin(sp.p, sp.ng, wi_surf)))
        o = torch.where(alive[..., None], o2, o)
        d = torch.where(alive[..., None], wi_w, d)
        vert = vert + vertex.to(i32)

        # Russian roulette at real vertices
        rr_beta = torch.amax(beta, -1)
        q = (1.0 - rr_beta).clamp_min(0.05)
        do_rr = ((vert >= _RR_START) & (rr_beta < rr_threshold) & alive
                 & vertex)
        die = do_rr & (ub[6] < q)
        alive = alive & ~die
        denom = torch.where(do_rr & ~die, (1.0 - q).clamp_min(1e-6), 1.0)
        beta = torch.where(die[..., None], 0.0, beta / denom[..., None])

    zero = o.new_zeros(n)
    aov = torch.stack([zero, zero, zero, path_len.to(torch.float32)], -1)
    return (sampled_to_rgb(L) if n_chan != 3 else L), aov
