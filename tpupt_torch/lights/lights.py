"""Batched light sampling (counterpart of src/lights/ + core/light.h).

`sample_li` draws a direction toward a chosen light and returns incident
radiance, solid-angle pdf, and the shadow-ray parameters; `pdf_li_*` return
the pdf that light sampling would assign to a BSDF-sampled direction (for the
other MIS half, integrator.cpp:109-217 EstimateDirect). Area lights are
prim-linked rows: triangle lights sample the triangle uniformly by area
(triangle.cpp Sample), sphere lights sample the visible cone
(sphere.cpp:232-290 Sample(ref)). Point lights are the default of the
type select; goniometric and projection lights are point lights scaled by a
map, infinite lights sample the sphere uniformly or, with an environment
map, by its Distribution2D (lights/infinite.cpp).

Every gather of a table that can be a training parameter (light_L,
light_img, env_map) is an `index_select`, whose backward adds the
cotangents of repeated rows with atomics. The few light_L rows take a
contribution from every lane and bounce: `emitter_rows` sums those in
float64, where float32 atomics drop the smallest terms against a large
running sum (measured on the H100: the film's sum(light_L * dL/dlight_L)
fell 1e-5 short of the loss on a scene of every material)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpupt_torch.core.sampling import (Distribution2D, uniform_cone_pdf,
                                       uniform_sample_cone,
                                       uniform_sample_sphere,
                                       uniform_sample_triangle)
from tpupt_torch.core.vecmath import coordinate_system, cross, dot, length
from tpupt_torch.materials.bsdf import to_world
from tpupt_torch.scene.flatten import (LIGHT_AREA, LIGHT_DISTANT, LIGHT_GONIO,
                                       LIGHT_INFINITE, LIGHT_PROJECTION,
                                       LIGHT_SPOT)
from tpupt_torch.textures.textures import bilinear, rows


class LightSample(NamedTuple):
    wi: torch.Tensor       # (N,3) world, toward the light
    li: torch.Tensor       # (N,3) incident radiance (already distance-attenuated)
    pdf: torch.Tensor      # (N,) solid-angle pdf (1 for delta lights)
    dist: torch.Tensor     # (N,) shadow-ray length
    is_delta: torch.Tensor  # (N,) bool


def _world_radius(ds):
    return 0.5 * length(ds.world_hi - ds.world_lo) + 1e-3


def _light_img_fetch(ds, light_id, u, v):
    """Bilinear fetch from the per-light map atlas (gonio/projection); 1
    for a light without a map."""
    lid = light_id.long()
    off = ds.light_img_off[lid]
    w = ds.light_img_w[lid].clamp_min(1)
    h = ds.light_img_h[lid].clamp_min(1)
    n_tex = ds.light_img.shape[0]

    def texel(xi, yi):
        xi = torch.minimum(xi.to(torch.int32).clamp_min(0), w - 1)
        yi = torch.minimum(yi.to(torch.int32).clamp_min(0), h - 1)
        return rows(ds.light_img,
                    (off.clamp_min(0) + yi * w + xi).clamp(0, n_tex - 1))

    val = bilinear(u.clamp(0.0, 1.0) * w - 0.5, v.clamp(0.0, 1.0) * h - 0.5,
                   texel)
    return torch.where((off >= 0)[..., None], val, 1.0)


def _gather_tri_light_geo(ds, prim):
    prim = prim.long()
    p0, p1, p2 = ds.tri_p0[prim], ds.tri_p1[prim], ds.tri_p2[prim]
    nn = cross(p1 - p0, p2 - p0)
    area2 = length(nn)
    n = nn / area2.clamp_min(1e-20)[..., None]
    return p0, p1, p2, n, 0.5 * area2


def _sphere_center_radius(ds, sid):
    sid = sid.long()
    m = ds.sph_o2w[sid]
    c = m[..., :3, 3]
    # uniform-scale assumption for world radius (column norm)
    s = torch.sqrt(torch.sum(m[..., :3, 0] ** 2, -1))
    return c, ds.sph_radius[sid] * s


class _EmitterRows(torch.autograd.Function):
    """index_select(table, 0, idx) whose backward adds the lanes' cotangents
    into the rows in float64 (the forward launches what index_select does)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return torch.index_select(table, 0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        acc = g.new_zeros(ctx.table_shape, dtype=torch.float64)
        return acc.index_add_(0, idx, g.double()).to(g.dtype), None


def emitter_rows(light_L, lid):
    """light_L[lid], its cotangents summed per row in float64."""
    return _EmitterRows.apply(light_L, lid.long())


def sample_li(ds, st, light_id, p, u1, u2):
    """Sample one light toward shading points p (N,3). light_id (N,) i32."""
    lid = light_id.long()
    lL = emitter_rows(ds.light_L, lid)
    lpos = ds.light_pos[lid]
    ldir = ds.light_dir[lid]
    ct = ds.light_cos_total[lid]
    cf = ds.light_cos_falloff[lid]
    lt = ds.light_type[lid]
    lprim = ds.light_prim[lid]
    ltwo = ds.light_twosided[lid]
    wr = _world_radius(ds)

    n = p.shape[0]
    ones = p.new_ones(n)

    # --- point / spot ---
    to_l = lpos - p
    d2 = dot(to_l, to_l).clamp_min(1e-12)
    dist_p = torch.sqrt(d2)
    wi_p = to_l / dist_p[..., None]
    li_point = lL / d2[..., None]
    # spot falloff (lights/spot.cpp Falloff)
    cos_axis = dot(-wi_p, ldir)
    delta = ((cos_axis - ct) / (cf - ct).clamp_min(1e-6)).clamp(0.0, 1.0)
    falloff = delta * delta * (delta * delta)
    li_spot = li_point * torch.where(cos_axis < ct, 0.0,
                                   torch.where(cos_axis > cf, 1.0, falloff))[..., None]

    # --- goniometric / projection (lights/goniometric.cpp Scale,
    # lights/projection.cpp Projection): point light modulated by a map ---
    li_gonio = li_point
    li_proj = li_point
    if st.has_light_imgs:
        w2l = ds.light_w2l[lid]
        d_l = torch.einsum("nij,nj->ni", w2l, -wi_p)  # direction FROM light
        # gonio: equirect (theta from +z, phi in xy)
        theta = torch.arccos(d_l[..., 2].clamp(-1.0, 1.0))
        phi = torch.atan2(d_l[..., 1], d_l[..., 0])
        phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
        g_scale = _light_img_fetch(ds, light_id, phi / (2 * math.pi),
                                   theta / math.pi)
        li_gonio = li_point * g_scale
        # projection: perspective map through the fov window
        wz = d_l[..., 2].clamp_min(1e-6)
        half_tan = torch.tan(torch.arccos(ct.clamp(-1.0, 1.0)))
        aspect = (ds.light_img_w[lid].to(torch.float32)
                  / ds.light_img_h[lid].clamp_min(1))
        su = d_l[..., 0] / (wz * half_tan.clamp_min(1e-6))
        sv = d_l[..., 1] / (wz * half_tan.clamp_min(1e-6)) * aspect
        in_frustum = ((d_l[..., 2] > 1e-3) & (torch.abs(su) <= 1.0)
                      & (torch.abs(sv) <= 1.0))
        p_scale = _light_img_fetch(ds, light_id, (su + 1.0) * 0.5,
                                   (sv + 1.0) * 0.5)
        li_proj = li_point * torch.where(in_frustum[..., None], p_scale, 0.0)

    # --- distant (lights/distant.cpp Sample_Li) ---
    wi_d = ldir
    dist_d = 2.0 * ones * wr

    # --- infinite: env-map importance sampling, else uniform sphere; the
    # shadow ray runs past the scene (twice its bounding radius) ---
    wi_inf = uniform_sample_sphere(u1, u2)
    li_inf = lL
    pdf_inf = ones / (4.0 * math.pi)
    dist_inf = 2.0 * ones * wr
    if st.env_w > 0:
        wi_env, li_env, pdf_env = sample_env(ds, st, u1, u2)
        is_env = light_id == st.env_light_id
        wi_inf = torch.where(is_env[..., None], wi_env, wi_inf)
        li_inf = torch.where(is_env[..., None], li_env, li_inf)
        pdf_inf = torch.where(is_env, pdf_env, pdf_inf)

    # --- area: triangle or sphere prim ---
    is_tri_prim = lprim < st.n_tris
    tid = lprim.clamp(0, max(st.n_tris - 1, 0))
    p0, p1, p2, tn, area = _gather_tri_light_geo(ds, tid)
    b0, b1 = uniform_sample_triangle(u1, u2)
    p_l = p0 * b0[..., None] + p1 * b1[..., None] + p2 * (1.0 - b0 - b1)[..., None]
    to_pl = p_l - p
    d2_l = dot(to_pl, to_pl).clamp_min(1e-12)
    dist_tri = torch.sqrt(d2_l)
    wi_tri = to_pl / dist_tri[..., None]
    cos_l = dot(tn, -wi_tri)
    facing = torch.where(ltwo, torch.abs(cos_l) > 1e-7, cos_l > 1e-7)
    pdf_tri = d2_l / (torch.abs(cos_l) * area).clamp_min(1e-12)
    li_tri = torch.where(facing[..., None], lL, 0.0)

    sid = (lprim - st.n_tris).clamp(0, max(st.n_spheres - 1, 0))
    sc, sr = _sphere_center_radius(ds, sid)
    to_c = sc - p
    dc2 = dot(to_c, to_c).clamp_min(1e-12)
    dc = torch.sqrt(dc2)
    inside = dc2 <= sr * sr * 1.0001
    # cone sampling toward the sphere (sphere.cpp:232 Sample(ref,u)).
    # NaN-safe guards matter for GRADIENTS, not values: non-sphere lights
    # still evaluate this branch on dummy geometry (sr == 0), and an
    # unselected branch's inf/sqrt(0) forward values turn a zero cotangent
    # into NaN in reverse mode (0 * inf)
    sin2_max = (sr * sr / dc2).clamp(0.0, 1.0 - 1e-7)
    cos_max = torch.sqrt(1.0 - sin2_max)
    w_axis = to_c / dc[..., None]
    local = uniform_sample_cone(u1, u2, cos_max)
    t_ax, b_ax = coordinate_system(w_axis)
    wi_sph = to_world(t_ax, b_ax, w_axis, local)
    pdf_sph = uniform_cone_pdf(cos_max.clamp_max(1.0 - 1e-7))
    # distance to the sampled sphere point along wi (law of cosines)
    cos_alpha = local[..., 2]
    ds_ = dc * cos_alpha - torch.sqrt(
        (sr * sr - dc2 * (1.0 - cos_alpha * cos_alpha)).clamp_min(1e-20))
    li_sph = lL
    # inside the sphere (the reference area-samples, sphere.cpp:232): our
    # cone sampler cannot generate useful directions, so the light
    # strategy is declared DEAD — li = 0 AND pdf = 0. pdf_li mirrors
    # this, so the BSDF-sampled side's MIS weight becomes 1 and emission
    # reaches the path at full weight (leaving pdf > 0 here while
    # contributing nothing made MIS down-weight BSDF hits by a density
    # the light strategy never delivered: a measured energy loss on the
    # analytic interior-sphere-light scene)
    li_sph = torch.where(inside[..., None], 0.0, li_sph)
    pdf_sph = torch.where(inside, 0.0, pdf_sph)

    wi_area = torch.where(is_tri_prim[..., None], wi_tri, wi_sph)
    li_area = torch.where(is_tri_prim[..., None], li_tri, li_sph)
    pdf_area = torch.where(is_tri_prim, pdf_tri, pdf_sph)
    dist_area = torch.where(is_tri_prim, dist_tri, ds_)

    # --- select by light type ---
    wi = wi_p
    li = li_point
    pdf = ones
    dist = dist_p
    delta_flag = torch.ones(n, dtype=torch.bool, device=p.device)
    for tid_, w_, l_, pf_, dd_, df_ in (
        (LIGHT_SPOT, wi_p, li_spot, ones, dist_p, True),
        (LIGHT_GONIO, wi_p, li_gonio, ones, dist_p, True),
        (LIGHT_PROJECTION, wi_p, li_proj, ones, dist_p, True),
        (LIGHT_DISTANT, wi_d, lL, ones, dist_d, True),
        (LIGHT_INFINITE, wi_inf, li_inf, pdf_inf, dist_inf, False),
        (LIGHT_AREA, wi_area, li_area, pdf_area, dist_area, False),
    ):
        sel = lt == tid_
        wi = torch.where(sel[..., None], w_, wi)
        li = torch.where(sel[..., None], l_, li)
        pdf = torch.where(sel, pf_, pdf)
        dist = torch.where(sel, dd_, dist)
        delta_flag = torch.where(sel, df_, delta_flag)

    return LightSample(wi=wi, li=li, pdf=pdf, dist=dist, is_delta=delta_flag)


def pdf_li(ds, st, p, wi, hit_prim, hit_t):
    """Light-sampling pdf for direction wi that hit prim `hit_prim` at
    distance hit_t (used for the BSDF half of MIS)."""
    is_tri = hit_prim < st.n_tris
    tid = hit_prim.clamp(0, max(st.n_tris - 1, 0))
    _, _, _, tn, area = _gather_tri_light_geo(ds, tid)
    cos_l = torch.abs(dot(tn, -wi))
    pdf_tri = (hit_t * hit_t) / (cos_l * area).clamp_min(1e-12)

    sid = (hit_prim - st.n_tris).clamp(0, max(st.n_spheres - 1, 0))
    sc, sr = _sphere_center_radius(ds, sid)
    to_c = sc - p
    dc2 = dot(to_c, to_c).clamp_min(1e-12)
    # same gradient-safety guards as sample_li: tri-hit lanes still
    # evaluate this branch on dummy sphere geometry (sr == 0), where
    # cos_max == 1 makes the cone pdf inf and 0-cotangents go NaN
    sin2_max = (sr * sr / dc2).clamp(0.0, 1.0 - 1e-7)
    cos_max = torch.sqrt(1.0 - sin2_max)
    pdf_sph = uniform_cone_pdf(cos_max.clamp_max(1.0 - 1e-7))
    # from inside the sphere the light strategy is dead (see sample_li);
    # its claimed density must be 0 so the BSDF side's MIS weight is 1
    pdf_sph = torch.where(dc2 <= sr * sr * 1.0001, 0.0, pdf_sph)

    return torch.where(is_tri, pdf_tri, pdf_sph)


# ------------------------- environment map light ---------------------------
# (lights/infinite.cpp InfiniteAreaLight: equirect map, luminance*sin(theta)
# importance distribution, bilinear radiance lookup)


def _env_distribution(ds):
    return Distribution2D(ds.env_cond_func, ds.env_cond_cdf,
                          ds.env_cond_integral, ds.env_marg_func,
                          ds.env_marg_cdf, ds.env_marg_integral)


def _env_uv(ds, d_world):
    d_l = d_world @ ds.env_w2l.T
    theta = torch.arccos(d_l[..., 2].clamp(-1.0, 1.0))
    phi = torch.atan2(d_l[..., 1], d_l[..., 0])
    phi = torch.where(phi < 0, phi + 2 * math.pi, phi)
    return phi / (2 * math.pi), theta / math.pi, theta


def _env_fetch(ds, st, u, v):
    """Bilinear fetch from the flat equirect map: u wraps, v clamps."""
    w, h = st.env_w, st.env_h

    def texel(xi, yi):
        xi = torch.remainder(xi.to(torch.int32), w)
        yi = yi.to(torch.int32).clamp(0, h - 1)
        return rows(ds.env_map, yi * w + xi)

    return bilinear(u * w - 0.5, v * h - 0.5, texel)


def env_radiance(ds, st, d_world):
    """Le of the environment for escaped rays (InfiniteAreaLight::Le)."""
    u, v, _ = _env_uv(ds, d_world)
    return _env_fetch(ds, st, u, v)


def env_pdf(ds, st, d_world):
    """Solid-angle pdf the env importance sampler assigns to direction d
    (infinite.cpp Pdf_Li)."""
    u, v, theta = _env_uv(ds, d_world)
    pdf_uv = _env_distribution(ds).pdf(u, v)
    sin_t = torch.sin(theta).clamp_min(1e-6)
    return pdf_uv / (2.0 * math.pi * math.pi * sin_t)


def sample_env(ds, st, u1, u2):
    """Importance-sample the environment (infinite.cpp Sample_Li).
    Returns (wi_world, Li, pdf)."""
    (u, v), pdf_uv = _env_distribution(ds).sample_continuous(u1, u2)
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    sin_t = torch.sin(theta)
    d_l = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                       torch.cos(theta)], -1)
    wi = d_l @ ds.env_w2l  # inverse of the w2l rotation = transpose
    li = _env_fetch(ds, st, u, v)
    pdf = pdf_uv / (2.0 * math.pi * math.pi * sin_t).clamp_min(1e-9)
    pdf = torch.where(sin_t <= 1e-6, 0.0, pdf)
    return wi, li, pdf


def emitted_radiance(ds, st, hit_prim, hit_light, wo_world, ns):
    """Le of an emissive prim toward wo (DiffuseAreaLight::L, diffuse.cpp:49):
    L if the outgoing direction is on the emitting side (or twosided)."""
    lid = hit_light.clamp(0, max(st.n_lights - 1, 0))
    L = emitter_rows(ds.light_L, lid)
    two = ds.light_twosided[lid.long()]
    emit = (hit_light >= 0) & (two | (dot(ns, wo_world) > 0.0))
    return torch.where(emit[..., None], L, 0.0)
