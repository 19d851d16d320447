"""Wavefront bidirectional path tracer (counterpart of integrators/bdpt.cpp;
the JAX package's integrators/bdpt.py).

The reference builds per-ray camera and light subpaths of pointer-linked
`Vertex` records (bdpt.h:280-520), connects every (s,t) strategy pair
(ConnectBDPT, bdpt.cpp:445) and weights each with the recursive MIS
ri-product (MISWeight, bdpt.cpp:230). Here each subpath is a list of
vertex batches (one dict of (N,...) tensors per vertex index: the path
length is a Python bound, liveness a mask), the (s,t) double loop is
unrolled, and every connection's visibility ray is one batched any-hit
call of the renderer's traversal (K1, K2 or K3 on the card). t == 1
strategies (the light subpath reaching the camera lens) become film
splats, as the reference's `film->AddSplat` (bdpt.cpp:410).

Light subpaths start from every light family including the environment
(infinite.cpp Sample_Le: an env-importance direction and a disk origin,
with the subpath density corrections of bdpt.cpp:124-136); escaped camera
rays become infinite-light endpoint vertices (bdpt.cpp:170-176).

Sampler dimensions: the camera walk draws 40 + 3i, the light start
40 + 3 t_max + 1 onwards, the light walk 40 + 3 t_max + 8 + 3i, the
connections 200 + 3k (k = (s + t) mod (t_max + 2)), in the JAX package's
order: MLT's `PSSSampler` hands out its columns in request order."""

from __future__ import annotations

import math

import torch

from tpupt_torch.core.sampling import (concentric_sample_disk,
                                       cosine_sample_hemisphere,
                                       uniform_sample_cone,
                                       uniform_sample_sphere,
                                       uniform_sample_triangle)
from tpupt_torch.core.spectrum import sampled_to_rgb
from tpupt_torch.core.vecmath import (coordinate_system, dot, length,
                                      normalize, offset_ray_origin)
from tpupt_torch.integrators.path import (detached_traversal,
                                          miss_radiance_and_pdf,
                                          pick_traversal, shading_point,
                                          sph_shade_table, tri_shade_table,
                                          uplift)
from tpupt_torch.lights.lights import (_gather_tri_light_geo,
                                       _sphere_center_radius, _world_radius,
                                       emitted_radiance, env_pdf, sample_env,
                                       sample_li)
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.scene.flatten import (LIGHT_AREA, LIGHT_DISTANT, LIGHT_GONIO,
                                       LIGHT_INFINITE, LIGHT_POINT,
                                       LIGHT_PROJECTION, LIGHT_SPOT)

INV_4PI = 1.0 / (4.0 * math.pi)

# vertex types (bdpt.h VertexType)
VT_CAMERA, VT_LIGHT, VT_SURFACE = 0, 1, 2


def _remap0(x):
    """MISWeight's remap0: 0 densities become 1 so deltas cancel
    (bdpt.cpp:223)."""
    return torch.where(x != 0.0, x, 1.0)


def _mat(ds, st, v):
    """The material parameters at a vertex batch (as the JAX package
    gathers them for BDPT: no ptex face, no Fourier table)."""
    return bx.gather_mat_params(ds, v["mat"], uv=v["uv"], p=v["p"],
                                has_textures=st.has_textures,
                                tex_types=st.tex_types,
                                has_mix="mix" in st.mat_features)


def convert_density(pdf_dir, p_from, p_to, ns_to, to_is_surface,
                    to_is_infinite=None):
    """Solid-angle -> area density (Vertex::ConvertDensity, bdpt.h:321).
    Densities toward infinite-light vertices stay in solid angle
    (bdpt.h:328-329)."""
    w = p_to - p_from
    d2 = dot(w, w).clamp_min(1e-12)
    inv_d2 = 1.0 / d2
    cos_t = torch.abs(dot(ns_to, w * torch.sqrt(inv_d2)[..., None]))
    out = pdf_dir * torch.where(to_is_surface, cos_t, 1.0) * inv_d2
    if to_is_infinite is not None:
        out = torch.where(to_is_infinite, pdf_dir, out)
    return out


def infinite_light_density(ds, st, d):
    """Combined solid-angle density x choice pmf of sampling direction d
    from the scene's infinite lights (InfiniteLightDensity, bdpt.h:113)."""
    n = d.shape[0]
    dens = d.new_zeros(n)
    if st.n_lights == 0:
        return dens
    is_inf = ds.light_type == LIGHT_INFINITE
    const_pmf = torch.sum(torch.where(is_inf, ds.light_pdf, 0.0))
    if st.env_light_id >= 0:
        env_pmf = ds.light_pdf[st.env_light_id]
        dens = dens + env_pdf(ds, st, d) * env_pmf
        const_pmf = const_pmf - env_pmf
    return dens + INV_4PI * const_pmf.clamp_min(0.0)


def _g_term(ds, st, intersect, va, vb):
    """Geometry term with visibility (bdpt.cpp G, :227-243): one any-hit
    call."""
    w = vb["p"] - va["p"]
    d2 = dot(w, w).clamp_min(1e-12)
    dist = torch.sqrt(d2)
    wn = w / dist[..., None]
    g = torch.abs(dot(va["ns"], wn)) * torch.abs(dot(vb["ns"], wn)) / d2
    o_sh = offset_ray_origin(va["p"], va["ns"], wn)
    occluded = intersect(o_sh, wn, dist * 0.997, any_hit=True)[0].valid
    return torch.where(occluded, 0.0, g), wn, dist


def _vertex_f(ds, st, v, wi_world, features):
    """BSDF value and pdf at a surface vertex toward wi (Vertex::f,
    bdpt.h:340). The shading-normal correction of light-subpath vertices
    (CorrectShadingNormal, bdpt.cpp:53) is 1 here, as in the JAX package."""
    mp = _mat(ds, st, v)
    t_f, b_f, n_f = bx.make_frame(v["ns"])
    wo_l = bx.to_local(t_f, b_f, n_f, v["wo"])
    wi_l = bx.to_local(t_f, b_f, n_f, wi_world)
    return bx.eval_pdf(mp, wo_l, wi_l, features, st.mix_features)


def _vertex_pdf(ds, st, v, prev_p, next_v, features):
    """Area density of sampling next from v given the direction from prev
    (Vertex::Pdf, bdpt.h:430)."""
    wo = normalize(prev_p - v["p"])
    wi = normalize(next_v["p"] - v["p"])
    mp = _mat(ds, st, v)
    t_f, b_f, n_f = bx.make_frame(v["ns"])
    _, pdf = bx.eval_pdf(mp, bx.to_local(t_f, b_f, n_f, wo),
                         bx.to_local(t_f, b_f, n_f, wi), features,
                         st.mix_features)
    return convert_density(pdf, v["p"], next_v["p"], next_v["ns"],
                           next_v["on_surface"], next_v.get("infinite"))


# --------------------------- light Sample_Le --------------------------------


def sample_le(ds, st, light_id, u0, u1, u2, u3):
    """Emission sampling (Light::Sample_Le family) for every light type:
    returns (position, normal at the light, direction, Le, pdf_pos,
    pdf_dir, delta origin, delta direction)."""
    lid = light_id.long()
    lt = ds.light_type[lid]
    lL = ds.light_L[lid]
    lpos = ds.light_pos[lid]
    ldir = ds.light_dir[lid]
    lprim = ds.light_prim[lid]
    n = light_id.shape[0]
    wr = _world_radius(ds)

    # point: uniform sphere (point.cpp Sample_Le)
    d_pt = uniform_sample_sphere(u2, u3)
    # spot: uniform cone around the axis (spot.cpp Sample_Le)
    ct = ds.light_cos_total[lid]
    local = uniform_sample_cone(u2, u3, ct)
    t_ax, b_ax = coordinate_system(ldir)
    d_spot = bx.to_world(t_ax, b_ax, ldir, local)
    pdf_dir_spot = 1.0 / (2.0 * math.pi * (1.0 - ct)).clamp_min(1e-9)
    cf = ds.light_cos_falloff[lid]
    cos_axis = dot(d_spot, ldir)
    delta_f = ((cos_axis - ct) / (cf - ct).clamp_min(1e-6)).clamp(0.0, 1.0)
    fall = torch.where(cos_axis < ct, 0.0,
                       torch.where(cos_axis > cf, 1.0, delta_f ** 4))

    # area (triangle prim): uniform area + cosine hemisphere (diffuse.cpp
    # Sample_Le; twosided lights flip the hemisphere on half the samples,
    # diffuse.cpp:106-118)
    two = ds.light_twosided[lid]
    tid = lprim.clamp(0, max(st.n_tris - 1, 0))
    p0, p1, p2, tn, area = _gather_tri_light_geo(ds, tid)
    b0, b1 = uniform_sample_triangle(u0, u1)
    p_area = (p0 * b0[..., None] + p1 * b1[..., None]
              + p2 * (1.0 - b0 - b1)[..., None])
    flip = two & (u2 < 0.5)
    u2a = torch.where(two, (2.0 * torch.where(u2 < 0.5, u2, u2 - 0.5))
                      .clamp_max(0.999999), u2)
    w_local = cosine_sample_hemisphere(u2a, u3)
    t_a, b_a = coordinate_system(tn)
    tn_eff = torch.where(flip[..., None], -tn, tn)
    d_area = bx.to_world(t_a, b_a, tn_eff, w_local)
    pdf_pos_area = 1.0 / area.clamp_min(1e-12)
    pdf_dir_area = (torch.abs(w_local[..., 2]) / math.pi
                    * torch.where(two, 0.5, 1.0))
    # sphere-prim area lights: sample the sphere surface
    sid = (lprim - st.n_tris).clamp(0, max(st.n_spheres - 1, 0))
    sc, sr = _sphere_center_radius(ds, sid)
    n_sph = uniform_sample_sphere(u0, u1)
    p_sph = sc + sr[..., None] * n_sph
    d_sph_l = cosine_sample_hemisphere(u2, u3)
    t_s, b_s = coordinate_system(n_sph)
    d_sph = bx.to_world(t_s, b_s, n_sph, d_sph_l)
    pdf_pos_sph = 1.0 / (4.0 * math.pi * sr * sr).clamp_min(1e-12)
    is_tri = (lprim < st.n_tris)[..., None]
    p_ar = torch.where(is_tri, p_area, p_sph)
    n_ar = torch.where(is_tri, tn, n_sph)
    d_ar = torch.where(is_tri, d_area, d_sph)
    pdf_pos_ar = torch.where(is_tri[..., 0], pdf_pos_area, pdf_pos_sph)
    pdf_dir_ar = torch.where(is_tri[..., 0], pdf_dir_area,
                             torch.abs(d_sph_l[..., 2]) / math.pi)

    # distant: disk behind the scene (distant.cpp Sample_Le)
    dx, dy = concentric_sample_disk(u0, u1)
    t_d, b_d = coordinate_system(ldir)  # ldir points TOWARD the light
    centre = (ds.world_lo + ds.world_hi) * 0.5
    p_disk = centre + wr * (ldir + dx[..., None] * t_d + dy[..., None] * b_d)
    d_dist = -ldir
    pdf_pos_dist = (1.0 / (math.pi * wr * wr)).expand(n)

    # infinite (env): importance-sampled direction from the map + disk
    # origin behind the scene (infinite.cpp Sample_Le); constant infinite
    # lights take a uniform sphere direction
    if st.env_w > 0:
        wi_env, le_env, pdf_env = sample_env(ds, st, u2, u3)
    else:
        wi_env = d_pt
        le_env = u0.new_zeros((n, 3))
        pdf_env = u0.new_zeros(n)
    if st.env_light_id >= 0:
        is_env_l = light_id == st.env_light_id
    else:
        is_env_l = torch.zeros(n, dtype=torch.bool, device=u0.device)
    wi_inf = torch.where(is_env_l[..., None], wi_env, d_pt)
    d_inf = -wi_inf
    le_inf = torch.where(is_env_l[..., None], le_env, lL)
    pdf_dir_inf = torch.where(is_env_l, pdf_env, INV_4PI)
    t_e, b_e = coordinate_system(wi_inf)
    p_inf = centre + wr * (wi_inf + dx[..., None] * t_e
                           + dy[..., None] * b_e)

    is_area = (lt == LIGHT_AREA)[..., None]
    is_dist = (lt == LIGHT_DISTANT)[..., None]
    is_inf = (lt == LIGHT_INFINITE)[..., None]
    p = torch.where(is_area, p_ar,
                    torch.where(is_dist, p_disk,
                                torch.where(is_inf, p_inf, lpos)))
    nl = torch.where(is_area, n_ar,
                     torch.where(is_dist, -ldir,
                                 torch.where(is_inf, d_inf, d_pt)))
    d = d_pt
    ones = u0.new_ones(n)
    pdf_pos = ones
    pdf_dir = u0.new_full((n,), INV_4PI)
    le = lL
    for tid_, d_, pp_, pd_, le_ in (
        (LIGHT_SPOT, d_spot, ones, pdf_dir_spot, lL * fall[..., None]),
        (LIGHT_GONIO, d_pt, ones, u0.new_full((n,), INV_4PI), lL),
        (LIGHT_PROJECTION, d_spot, ones, pdf_dir_spot, lL),
        (LIGHT_AREA, d_ar, pdf_pos_ar, pdf_dir_ar, lL),
        (LIGHT_DISTANT, d_dist, pdf_pos_dist, ones, lL),
        (LIGHT_INFINITE, d_inf, pdf_pos_dist, pdf_dir_inf, le_inf),
    ):
        sel = lt == tid_
        d = torch.where(sel[..., None], d_, d)
        pdf_pos = torch.where(sel, pp_, pdf_pos)
        pdf_dir = torch.where(sel, pd_, pdf_dir)
        le = torch.where(sel[..., None], le_, le)
    delta_origin = ((lt == LIGHT_POINT) | (lt == LIGHT_SPOT)
                    | (lt == LIGHT_GONIO) | (lt == LIGHT_PROJECTION))
    delta_dir = lt == LIGHT_DISTANT
    return p, nl, d, le, pdf_pos, pdf_dir, delta_origin, delta_dir


def pdf_light_dir(ds, st, light_id, v_light, w):
    """Direction density of emitting w from a light vertex (the direction
    part of Light::Pdf_Le), in solid angle."""
    lid = light_id.long()
    lt = ds.light_type[lid]
    n = light_id.shape[0]
    cos_l = dot(v_light["ns"], w)
    two = ds.light_twosided[lid]
    pdf_area_dir = torch.where(two, 0.5 * torch.abs(cos_l),
                               cos_l.clamp_min(0.0)) / math.pi
    ct = ds.light_cos_total[lid]
    pdf_spot = torch.where(
        dot(w, ds.light_dir[lid]) >= ct,
        1.0 / (2.0 * math.pi * (1.0 - ct)).clamp_min(1e-9), 0.0)
    pdf = w.new_full((n,), INV_4PI)
    zeros = w.new_zeros(n)
    for tid_, p_ in ((LIGHT_AREA, pdf_area_dir), (LIGHT_SPOT, pdf_spot),
                     (LIGHT_PROJECTION, pdf_spot), (LIGHT_DISTANT, zeros),
                     (LIGHT_INFINITE, zeros)):
        pdf = torch.where(lt == tid_, p_, pdf)
    return pdf


def pdf_light_origin(ds, st, light_id, light_pmf):
    """Positional density of the light origin x choice pmf
    (Vertex::PdfLightOrigin, bdpt.h:500)."""
    lid = light_id.long()
    lt = ds.light_type[lid]
    lprim = ds.light_prim[lid]
    wr = _world_radius(ds)
    tid = lprim.clamp(0, max(st.n_tris - 1, 0))
    _, _, _, _, area = _gather_tri_light_geo(ds, tid)
    sid = (lprim - st.n_tris).clamp(0, max(st.n_spheres - 1, 0))
    _, sr = _sphere_center_radius(ds, sid)
    pdf_pos_ar = torch.where(
        lprim < st.n_tris, 1.0 / area.clamp_min(1e-12),
        1.0 / (4.0 * math.pi * sr * sr).clamp_min(1e-12))
    pdf = torch.ones_like(pdf_pos_ar)
    pdf = torch.where(lt == LIGHT_AREA, pdf_pos_ar, pdf)
    pdf = torch.where(lt == LIGHT_DISTANT, 1.0 / (math.pi * wr * wr), pdf)
    pdf = torch.where(lt == LIGHT_INFINITE, 0.0, pdf)
    return pdf * light_pmf


# ----------------------------- subpath walks --------------------------------


def _make_vertex(like, c=3):
    n = like.shape[0]
    z3 = like.new_zeros((n, 3))
    z = like.new_zeros(n)
    dev = like.device

    def b():
        return torch.zeros(n, dtype=torch.bool, device=dev)
    return dict(p=z3, ns=z3, beta=like.new_zeros((n, c)), wo=z3,
                uv=like.new_zeros((n, 2)), pdf_fwd=z, pdf_rev=z, delta=b(),
                type=torch.zeros(n, dtype=torch.int32, device=dev),
                mat=torch.zeros(n, dtype=torch.int32, device=dev),
                light=torch.full((n,), -1, dtype=torch.int32, device=dev),
                valid=b(), on_surface=b(), infinite=b(), escaped=b())


def random_walk(ds, st, intersect, features, o, d, beta, pdf_dir, n_steps,
                u_dims, alive0, transport_light, prev0=None, tables=None):
    """Shared camera / light random walk (bdpt.cpp RandomWalk, :69-130):
    one closest-hit call a step. Returns the list of surface vertex
    batches. `prev0` (the subpath's start vertex) receives its pdf_rev from
    the first bounce, as the reference's prev-pointer update does."""
    n = o.shape[0]
    spec = uplift(st)
    verts = []
    alive = alive0
    pdf_w = pdf_dir
    wr = _world_radius(ds)
    # escaped vertices carry zero radiance when the scene has no infinite
    # lights, so gating on n_lights keeps the vertex layout static
    has_inf = st.n_lights > 0
    true_n = torch.ones(n, dtype=torch.bool, device=o.device)
    for i in range(n_steps):
        hit, _ = intersect(o, d, torch.where(alive, math.inf, 0.0))
        sp = shading_point(ds, st, hit, o, d, tables)
        valid = alive & hit.valid
        v = _make_vertex(o, st.n_channels)
        v["p"] = sp.p
        v["ns"] = sp.ns
        v["uv"] = sp.uv
        v["mat"] = sp.mat
        v["light"] = sp.light
        v["wo"] = -d
        v["beta"] = beta
        v["type"] = torch.full((n,), VT_SURFACE, dtype=torch.int32,
                               device=o.device)
        v["valid"] = valid
        v["pdf_fwd"] = convert_density(pdf_w, o, sp.p, sp.ns, true_n)
        if not transport_light and has_inf:
            # escaped camera rays become infinite-light endpoint vertices
            # (bdpt.cpp:170-176): their solid-angle density stays
            # unconverted (ConvertDensity skips infinite lights, bdpt.h:329)
            esc = alive & ~hit.valid
            v["escaped"] = esc
            v["infinite"] = esc
            v["type"] = torch.where(esc, VT_LIGHT, v["type"])
            v["p"] = torch.where(esc[..., None], o + d * (2.0 * wr), v["p"])
            v["ns"] = torch.where(esc[..., None], -d, v["ns"])
            v["pdf_fwd"] = torch.where(esc, pdf_w, v["pdf_fwd"])

        # sample the continuation
        mp = _mat(ds, st, dict(mat=sp.mat, uv=sp.uv, p=sp.p))
        t_f, b_f, n_f = bx.make_frame(sp.ns)
        wo_l = bx.to_local(t_f, b_f, n_f, -d)
        u = u_dims[i]
        bs = bx.sample(mp, wo_l, u[0], u[1], u[2], features, st.mix_features)
        wi_w = bx.to_world(t_f, b_f, n_f, bs.wi)
        cos_w = torch.abs(dot(wi_w, sp.ns))
        ok = valid & (bs.pdf > 1e-9) & (torch.amax(bs.f, -1) > 0.0)
        v["delta"] = bs.specular & valid

        # reverse pdf of the PREVIOUS vertex (bdpt.cpp:118): the density
        # of sampling wo from wi here, converted at prev
        _, pdf_rev_dir = bx.eval_pdf(
            mp, bx.to_local(t_f, b_f, n_f, wi_w), wo_l, features,
            st.mix_features)
        prev = verts[i - 1] if i > 0 else prev0
        if prev is not None:
            prev["pdf_rev"] = torch.where(
                valid,
                convert_density(pdf_rev_dir, sp.p, prev["p"], prev["ns"],
                                prev.get("on_surface", true_n),
                                prev.get("infinite")),
                prev["pdf_rev"])
        v["on_surface"] = valid
        verts.append(v)

        thru = spec(bs.f) * (cos_w / bs.pdf.clamp_min(1e-9))[..., None]
        beta = torch.where(ok[..., None], beta * thru, 0.0)
        pdf_w = torch.where(bs.specular, 0.0, bs.pdf)
        o = offset_ray_origin(sp.p, sp.ng, wi_w)
        d = wi_w
        alive = ok
    return verts


# ------------------------------- cameras ------------------------------------


def camera_film_area(ds, xres, yres):
    """Film area on the z=1 plane in camera space (perspective.cpp:49-61)."""
    r2c = ds.raster_to_camera
    pmin = r2c @ r2c.new_tensor([0.0, 0.0, 0.0, 1.0])
    pmax = r2c @ r2c.new_tensor([float(xres), float(yres), 0.0, 1.0])
    pmin = pmin[:3] / torch.abs(pmin[2]).clamp_min(1e-9)
    pmax = pmax[:3] / torch.abs(pmax[2]).clamp_min(1e-9)
    return torch.abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1]))


def camera_pdf_we(ds, st, cam_pos, cam_fwd, film_area, w):
    """Directional importance density and We of the pinhole perspective
    camera (perspective.cpp Pdf_We / We)."""
    cos_t = dot(w, cam_fwd)
    ok = cos_t > 1e-4
    c2 = (cos_t * cos_t).clamp_min(1e-9)
    pdf_dir = torch.where(ok, 1.0 / (film_area * c2 * cos_t), 0.0)
    we = torch.where(ok, 1.0 / (film_area * c2 * c2), 0.0)
    return pdf_dir, we


def camera_raster_from_dir(ds, w, xres, yres):
    """Project a world direction through the camera to raster coordinates
    (camera->WorldToRaster, for the t == 1 splats). Returns (raster (N,2),
    inside the film (N,))."""
    c2w = ds.cam_to_world
    w_cam = (c2w[:3, :3].T @ w[..., None])[..., 0]
    z = w_cam[..., 2].clamp_min(1e-6)
    p_cam1 = w_cam / z[..., None]
    r2c = ds.raster_to_camera
    # invert the raster->camera affine on the z=1 plane
    px = (p_cam1[..., 0] - r2c[0, 3]) / r2c[0, 0]
    py = (p_cam1[..., 1] - r2c[1, 3]) / r2c[1, 1]
    inside = ((px >= 0) & (px < xres) & (py >= 0) & (py < yres)
              & (w_cam[..., 2] > 1e-6))
    return torch.stack([px, py], -1), inside


# ------------------------------ MIS weight ----------------------------------


def mis_weight(ds, st, features, cam_verts, light_verts, s, t, overrides,
               light0_delta, light0_pdf_fwd):
    """Balance-heuristic weight over all strategies generating this path
    (MISWeight, bdpt.cpp:230-300): the product of remapped pdf ratios
    walked from each connection endpoint. `overrides` maps "pt" / "ptm" /
    "qs" / "qsm" to the hypothetical reverse densities at the four
    endpoint slots."""
    p0 = cam_verts[0]["p"]
    n = p0.shape[0]
    no = torch.zeros(n, dtype=torch.bool, device=p0.device)
    sum_ri = p0.new_zeros(n)

    def cam_rev(i):
        if i == t - 1 and "pt" in overrides:
            return overrides["pt"]
        if i == t - 2 and "ptm" in overrides:
            return overrides["ptm"]
        return cam_verts[i]["pdf_rev"]

    def cam_delta(i):
        # connection endpoints are non-delta
        return no if i == t - 1 else cam_verts[i]["delta"]

    ri = p0.new_ones(n)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(cam_rev(i)) / _remap0(cam_verts[i]["pdf_fwd"])
        use = ~cam_delta(i) & ~cam_delta(i - 1)
        sum_ri = sum_ri + torch.where(use, ri, 0.0)

    def lt_rev(i):
        if i == s - 1 and "qs" in overrides:
            return overrides["qs"]
        if i == s - 2 and "qsm" in overrides:
            return overrides["qsm"]
        return light_verts[i]["pdf_rev"]

    def lt_fwd(i):
        if i == 0 and light0_pdf_fwd is not None:
            return light0_pdf_fwd
        return light_verts[i]["pdf_fwd"]

    def lt_delta(i):
        return no if i == s - 1 else light_verts[i]["delta"]

    ri = p0.new_ones(n)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(lt_rev(i)) / _remap0(lt_fwd(i))
        prev_delta = lt_delta(i - 1) if i > 0 else light0_delta
        use = ~lt_delta(i) & ~prev_delta
        sum_ri = sum_ri + torch.where(use, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


# ------------------------------- driver -------------------------------------


def bdpt_li(ds, st, sampler, max_depth, px, py, sample_idx, o, d,
            xres, yres, valid=None, strategy=None, p_raster_cam=None,
            isect=None, tables=None, with_stats=True):
    """One full-frame BDPT wavefront: returns (L, aov zeros, splat_pfilm,
    splat_L). L goes through the filter-weighted film (t >= 2
    strategies); the splats are the t == 1 light-path contributions.
    `valid` masks padded wavefront lanes: a padded lane emits no light
    subpath (the splats are normalised by one light path per real pixel
    sample, bdpt.cpp:365).

    `strategy=(s_sel, t_sel)` switches to the multiplexed single-strategy
    mode (MLT's path kernel, mlt.cpp:151-163): each lane keeps ONLY its
    selected (s, t) strategy, scaled by nStrategies = s_sel + t_sel (the
    uniform strategy-choice pmf), and the return becomes (L, p_raster):
    the lane's camera raster `p_raster_cam` for t >= 2 strategies, the
    lens projection for t == 1.

    Traversal calls at depth D: 2D + 1 closest-hit calls of the walks,
    and D (s == 1), (D - 1) D / 2 (s >= 2) and D (t == 1) any-hit calls of
    the connections: 31 at depth 5."""
    isect = isect or pick_traversal(st)
    tables = tables or (tri_shade_table(ds), sph_shade_table(ds))
    intersect = detached_traversal(isect, ds, st, with_stats)
    features = st.mat_features
    n = o.shape[0]
    dev = o.device
    n_chan = st.n_channels
    spec = uplift(st)
    true_n = torch.ones(n, dtype=torch.bool, device=dev)
    false_n = torch.zeros(n, dtype=torch.bool, device=dev)
    if valid is None:
        valid = true_n
    t_max = max_depth + 2
    s_max = max_depth + 1
    if strategy is not None:
        s_sel, t_sel = strategy
        n_strats = (s_sel + t_sel).to(torch.float32)

        def _sel(s, t):
            return (s_sel == s) & (t_sel == t)
    else:
        def _sel(s, t):
            return true_n
        n_strats = o.new_ones(n)

    cam_pos = o
    c2w = ds.cam_to_world
    cam_fwd = normalize(c2w[:3, 2])[None].expand(n, 3)
    film_area = camera_film_area(ds, xres, yres)

    def dims(base, k):
        return [sampler.dim(px, py, sample_idx, base + j) for j in range(k)]

    # ---------------- camera subpath ----------------
    pdf_cam_dir, _ = camera_pdf_we(ds, st, cam_pos, cam_fwd, film_area, d)
    v_cam0 = _make_vertex(o, n_chan)
    v_cam0["p"] = cam_pos
    v_cam0["ns"] = cam_fwd
    v_cam0["beta"] = o.new_ones((n, n_chan))
    v_cam0["pdf_fwd"] = o.new_ones(n)
    v_cam0["type"] = torch.full((n,), VT_CAMERA, dtype=torch.int32,
                                device=dev)
    v_cam0["valid"] = true_n
    u_cam = [torch.stack(dims(40 + 3 * i, 3)) for i in range(t_max - 1)]
    cam_surf = random_walk(ds, st, intersect, features, o, d,
                           o.new_ones((n, n_chan)), pdf_cam_dir, t_max - 1,
                           u_cam, valid, transport_light=False,
                           tables=tables)
    cam_verts = [v_cam0] + cam_surf

    # ---------------- light subpath ----------------
    u_l = dims(40 + 3 * t_max + 1, 5)
    light_cdf = torch.cumsum(ds.light_pdf, 0)
    n_l1 = max(st.n_lights - 1, 0)
    lid = torch.searchsorted(light_cdf, u_l[0].contiguous(), right=True) \
        .clamp(0, n_l1).to(torch.int32)
    pmf = ds.light_pdf[lid.long()]
    p_l, n_l, d_l, le, pdf_pos, pdf_dir, delta_o, delta_d = sample_le(
        ds, st, lid, u_l[1], u_l[2], u_l[3], u_l[4])
    v_l0 = _make_vertex(o, n_chan)
    v_l0["p"] = p_l
    v_l0["ns"] = n_l
    denom = (pmf * pdf_pos * pdf_dir).clamp_min(1e-12)
    cos0 = torch.abs(dot(n_l, d_l))
    v_l0["beta"] = spec(le) * (cos0 / denom)[..., None]
    v_l0["pdf_fwd"] = pmf * pdf_pos
    v_l0["type"] = torch.full((n,), VT_LIGHT, dtype=torch.int32, device=dev)
    # the light START vertex keeps delta == false; IsDeltaLight() enters the
    # MIS loop only at i == 0 (bdpt.cpp:291, bdpt.h:168 default)
    v_l0["light"] = lid
    lt0 = ds.light_type[lid.long()]
    lt0_inf = lt0 == LIGHT_INFINITE
    v_l0["on_surface"] = (lt0 == LIGHT_AREA) | (lt0 == LIGHT_DISTANT)
    v_l0["infinite"] = lt0_inf
    l_alive = (valid & (st.n_lights > 0) & (torch.amax(le, -1) > 0.0)
               & (pdf_dir > 0.0))
    v_l0["valid"] = l_alive
    u_lt = [torch.stack(dims(40 + 3 * t_max + 8 + 3 * i, 3))
            for i in range(s_max - 1)]
    o_l = offset_ray_origin(p_l, torch.where(
        (torch.abs(n_l).sum(-1) > 1e-6)[..., None], n_l, d_l), d_l)
    light_surf = random_walk(ds, st, intersect, features, o_l, d_l,
                             v_l0["beta"], pdf_dir, s_max - 1, u_lt, l_alive,
                             transport_light=True, prev0=v_l0, tables=tables)
    # the subpath density corrections for infinite lights
    # (bdpt.cpp:124-136): the start vertex carries the combined solid-angle
    # density, the first surface vertex the planar positional density
    v_l0["pdf_fwd"] = torch.where(lt0_inf,
                                  infinite_light_density(ds, st, d_l),
                                  v_l0["pdf_fwd"])
    if light_surf:
        s1 = light_surf[0]
        corr = pdf_pos * torch.where(
            s1["on_surface"], torch.abs(dot(d_l, s1["ns"])), 1.0)
        s1["pdf_fwd"] = torch.where(lt0_inf & s1["valid"], corr,
                                    s1["pdf_fwd"])
    light_verts = [v_l0] + light_surf

    L = o.new_zeros((n, n_chan))
    splat_p = []
    splat_L = []
    u_conn = [torch.stack(dims(200 + 3 * k, 3)) for k in range(t_max + 2)]
    wr_s = _world_radius(ds)

    for t in range(2, t_max + 1):
        pt = cam_verts[t - 1]
        ptm = cam_verts[t - 2]

        # ---- s == 0: the camera path alone (bdpt.cpp:455) ----
        wo_pt = pt["wo"]
        le0 = emitted_radiance(ds, st, torch.zeros_like(pt["light"]),
                               pt["light"], wo_pt, pt["ns"])
        esc = pt["escaped"]
        d_esc = -wo_pt
        le_esc, _ = miss_radiance_and_pdf(ds, st, d_esc)
        le0 = torch.where(esc[..., None], le_esc, le0)
        c0 = pt["beta"] * spec(le0)
        can0 = (((pt["valid"] & (pt["light"] >= 0)) | esc)
                & (torch.amax(c0, -1) > 0.0))
        lid0 = pt["light"].clamp(0, n_l1)
        pmf0 = ds.light_pdf[lid0.long()]
        # escaped endpoint: PdfLightOrigin = InfiniteLightDensity(d);
        # PdfLight toward ptm = the planar disk density (bdpt.h:371-383,
        # 400-403)
        ov_pt = torch.where(esc, infinite_light_density(ds, st, d_esc),
                            pdf_light_origin(ds, st, lid0, pmf0))
        ptm_inf = (1.0 / (math.pi * wr_s * wr_s)) * torch.where(
            ptm["on_surface"], torch.abs(dot(ptm["ns"], d_esc)), 1.0)
        ov_ptm = torch.where(
            esc, ptm_inf,
            convert_density(
                pdf_light_dir(ds, st, lid0, pt,
                              normalize(ptm["p"] - pt["p"])),
                pt["p"], ptm["p"], ptm["ns"], true_n))
        ov = {"pt": ov_pt, "ptm": ov_ptm}
        if t == 2:
            w0 = o.new_ones(n)  # a directly visible light
        else:
            w0 = mis_weight(ds, st, features, cam_verts, light_verts, 0, t,
                            ov, false_n, None)
        L = L + torch.where((can0 & _sel(0, t))[..., None],
                            c0 * (w0 * n_strats)[..., None], 0.0)

        for s in range(1, s_max + 1):
            if s + t > max_depth + 2:
                break
            uc = u_conn[(s + t) % len(u_conn)]
            if s == 1:
                # resample a light toward pt (bdpt.cpp:462-490)
                lid1 = torch.searchsorted(light_cdf, uc[0].contiguous(),
                                          right=True).clamp(0, n_l1) \
                    .to(torch.int32)
                pmf1 = ds.light_pdf[lid1.long()]
                ls = sample_li(ds, st, lid1, pt["p"], uc[1], uc[2])
                f_pt, _ = _vertex_f(ds, st, pt, ls.wi, features)
                o_sh = offset_ray_origin(pt["p"], pt["ns"], ls.wi)
                occ = intersect(o_sh, ls.wi, ls.dist * 0.997,
                                any_hit=True)[0].valid
                c = pt["beta"] * spec(f_pt) * (
                    torch.abs(dot(ls.wi, pt["ns"]))
                    / (ls.pdf * pmf1).clamp_min(1e-12))[..., None] \
                    * spec(ls.li)
                can = (pt["valid"] & ~occ & (ls.pdf > 0.0)
                       & (torch.amax(c, -1) > 0.0))
                # the sampled light vertex, for MIS
                q_samp = _make_vertex(o, n_chan)
                p_samp = pt["p"] + ls.wi * ls.dist[..., None]
                q_samp["p"] = p_samp
                # the true light-surface normal at the sampled point (the
                # MIS densities need the emitter's cos, not the direction)
                lprim1 = ds.light_prim[lid1.long()]
                tid1 = lprim1.clamp(0, max(st.n_tris - 1, 0))
                _, _, _, tn1, _ = _gather_tri_light_geo(ds, tid1)
                sid1 = (lprim1 - st.n_tris).clamp(0, max(st.n_spheres - 1, 0))
                sc1, _ = _sphere_center_radius(ds, sid1)
                n_sph1 = normalize(p_samp - sc1)
                ns1 = torch.where((lprim1 < st.n_tris)[..., None], tn1,
                                  n_sph1)
                q_samp["ns"] = torch.where((lprim1 >= 0)[..., None], ns1,
                                           -ls.wi)
                q_samp["light"] = lid1
                q_samp["valid"] = can
                lt1 = ds.light_type[lid1.long()]
                lt1_inf = lt1 == LIGHT_INFINITE
                q_samp["on_surface"] = ((lt1 == LIGHT_AREA)
                                        | (lt1 == LIGHT_DISTANT))
                q_samp["infinite"] = lt1_inf
                lv = [q_samp]
                # pt's reverse density: PdfLight from the sampled vertex
                # (bdpt.cpp a3); infinite lights take the planar disk
                # density (bdpt.h:371)
                pt_ov = convert_density(
                    pdf_light_dir(ds, st, lid1, q_samp, -ls.wi),
                    q_samp["p"], pt["p"], pt["ns"], true_n)
                pt_ov = torch.where(
                    lt1_inf, (1.0 / (math.pi * wr_s * wr_s))
                    * torch.abs(dot(pt["ns"], ls.wi)), pt_ov)
                # ptm's reverse density: pt->Pdf(scene, sampled, *ptMinus)
                ov = {
                    "qs": _vertex_pdf(ds, st, pt, ptm["p"], q_samp,
                                      features),
                    "pt": pt_ov,
                    "ptm": _vertex_pdf(ds, st, pt, q_samp["p"], ptm,
                                       features),
                }
                l0_fwd = torch.where(
                    lt1_inf, infinite_light_density(ds, st, ls.wi),
                    pdf_light_origin(ds, st, lid1, pmf1))
                w = mis_weight(ds, st, features, cam_verts, lv, 1, t, ov,
                               ls.is_delta, l0_fwd)
                L = L + torch.where((can & _sel(1, t))[..., None],
                                    c * (w * n_strats)[..., None], 0.0)
            else:
                qs = light_verts[s - 1]
                qsm = light_verts[s - 2]
                g, wn, dist = _g_term(ds, st, intersect, qs, pt)
                f_qs, pdf_qs_fwd = _vertex_f(ds, st, qs, wn, features)
                f_pt, _ = _vertex_f(ds, st, pt, -wn, features)
                c = (qs["beta"] * spec(f_qs) * g[..., None] * spec(f_pt)
                     * pt["beta"])
                can = pt["valid"] & qs["valid"] & (torch.amax(c, -1) > 0.0)
                ov = {
                    "qs": _vertex_pdf(ds, st, pt, ptm["p"], qs, features),
                    "pt": convert_density(pdf_qs_fwd, qs["p"], pt["p"],
                                          pt["ns"], true_n),
                    # ptm.pdfRev = pt.Pdf(qs, ptMinus) (bdpt.cpp a5)
                    "ptm": _vertex_pdf(ds, st, pt, qs["p"], ptm, features),
                    # qsMinus.pdfRev = qs.Pdf(pt, qsMinus) (bdpt.cpp:273)
                    "qsm": _vertex_pdf(ds, st, qs, pt["p"], qsm, features),
                }
                # IsDeltaLight includes DeltaDirection (distant) lights
                # (bdpt.h:259, bdpt.cpp:291)
                w = mis_weight(ds, st, features, cam_verts, light_verts,
                               s, t, ov, delta_o | delta_d, None)
                L = L + torch.where((can & _sel(s, t))[..., None],
                                    c * (w * n_strats)[..., None], 0.0)

    # ---- t == 1: the light subpath to the camera lens (bdpt.cpp:410) ----
    for s in range(2, s_max + 2):
        if s + 1 > max_depth + 2 or s - 1 >= len(light_verts):
            break
        qs = light_verts[s - 1]
        qsm = light_verts[s - 2]
        to_cam = cam_pos - qs["p"]
        dist = length(to_cam).clamp_min(1e-9)
        wc = to_cam / dist[..., None]
        pdf_dir_c, we = camera_pdf_we(ds, st, cam_pos, cam_fwd, film_area,
                                      -wc)
        praster, inside = camera_raster_from_dir(ds, -wc, xres, yres)
        f_qs, _ = _vertex_f(ds, st, qs, wc, features)
        # the camera's importance sample is a delta at the lens: pbrt folds
        # it as We * cos / dist^2 with pdf 1
        o_sh = offset_ray_origin(qs["p"], qs["ns"], wc)
        occ = intersect(o_sh, wc, dist * 0.997, any_hit=True)[0].valid
        cam_cos = torch.abs(dot(wc, cam_fwd))
        c = qs["beta"] * spec(f_qs) * (
            we * torch.abs(dot(wc, qs["ns"])) * cam_cos
            / (dist * dist).clamp_min(1e-9))[..., None]
        can = qs["valid"] & inside & ~occ & (torch.amax(c, -1) > 0.0)
        ov = {
            "qs": convert_density(pdf_dir_c, cam_pos, qs["p"], qs["ns"],
                                  true_n),
            "qsm": _vertex_pdf(ds, st, qs, cam_pos, qsm, features),
        }
        w = mis_weight(ds, st, features, [v_cam0], light_verts, s, 1, ov,
                       delta_o | delta_d, None)
        if strategy is None:
            splat_p.append(torch.where(can[..., None], praster, -1.0))
            splat_L.append(torch.where(can[..., None], c * w[..., None], 0.0))
        else:
            sel = can & _sel(s, 1)
            L = L + torch.where(sel[..., None],
                                c * (w * n_strats)[..., None], 0.0)
            splat_p.append(torch.where(sel[..., None], praster, 0.0))

    if n_chan != 3:
        L = sampled_to_rgb(L)
        splat_L = [sampled_to_rgb(x) for x in splat_L]

    if strategy is not None:
        # the lane's raster: the lens projection for the selected t == 1
        # strategy, the lane's own camera raster otherwise (mlt.cpp:160)
        pr_out = p_raster_cam
        if splat_p:
            pr_t1 = sum(splat_p)
            pr_out = torch.where((t_sel == 1)[..., None], pr_t1, pr_out)
        return L, pr_out

    if splat_p:
        sp_p = torch.cat(splat_p)
        sp_L = torch.cat(splat_L)
    else:
        sp_p = o.new_full((1, 2), -1.0)
        sp_L = o.new_zeros((1, 3))
    return L, o.new_zeros((n, 4)), sp_p, sp_L
