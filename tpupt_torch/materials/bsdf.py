"""Batched BSDF evaluation and sampling (counterpart of src/core/reflection.*,
microfacet.*, and the material implementations in src/materials/).

Every hit gathers its material row into a `MatParams` SoA batch; `sample` and
`eval_pdf` then compute all material models branch-free and select by type id:
the wavefront replacement for the reference's BxDF virtual dispatch
(reflection.h:210) and per-material ComputeScatteringFunctions.

Conventions match the reference: shading frame with n = +z, wo/wi in local
space, wo.z may be negative; materials mirror their reference counterparts:
  matte      -> Lambertian / Oren-Nayar            (materials/matte.cpp)
  plastic    -> Lambertian + TR microfacet Fresnel (materials/plastic.cpp)
  mirror     -> specular reflection                (materials/mirror.cpp)
  glass      -> Fresnel-weighted specular refl/trans (materials/glass.cpp)
  metal      -> TR microfacet conductor            (materials/metal.cpp)
  uber       -> Lambertian + TR microfacet         (materials/uber.cpp subset)
  substrate  -> Ashikhmin-Shirley FresnelBlend     (materials/substrate.cpp)
  translucent-> diffuse reflection + transmission  (materials/translucent.cpp subset)
  disney     -> diffuse + retro + sheen + clearcoat + GGX specular, with
                specTrans / thin / diffTrans / flatness  (materials/disney.cpp)
  hair       -> R / TT / TRT fiber lobes               (materials/hair.py)
  fourier    -> tabulated Fourier series                (materials/fourier.py)
  mix        -> amount-weighted pair of child rows     (materials/mixmat.cpp)
  subsurface / kdsubsurface -> a Fresnel specular interface here; the
                BSSRDF exit is sampled by the integrator (materials/bssrdf.py)
Microfacet sampling uses Trowbridge-Reitz visible-normal sampling
(microfacet.cpp TrowbridgeReitzSample), Smith height-correlated-free G1*G1.

`features` (SceneStatics.mat_features, static) names the families of the
scene among "disney", "hair", "fourier", "mix" and "sss": only those are
computed, so a scene without them launches what it launched before they
were ported.

Everything is out-of-place, and the sampled direction and its density are
detached from autograd (detached-sampling estimator), so gradients with
respect to the material tables can flow through f alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpupt_torch.core.sampling import cosine_sample_hemisphere
from tpupt_torch.materials.fourier import (fourier_f, fourier_pdf,
                                           fourier_sample)
from tpupt_torch.materials.hair import hair_f_pdf, hair_sample
from tpupt_torch.core.vecmath import (coordinate_system, cross, dot, normalize,
                                      safe_sqrt)
from tpupt_torch.textures.textures import (ALL_TYPES, TEX_FIELDS,
                                           eval_texture)

INV_PI = 0.3183098861837907

from tpupt_torch.scene.flatten import (MAT_DISNEY, MAT_FOURIER,  # noqa: E402
                                       MAT_GLASS, MAT_HAIR,
                                       MAT_KDSUBSURFACE, MAT_MATTE,
                                       MAT_METAL, MAT_MIRROR, MAT_MIX,
                                       MAT_NONE, MAT_PLASTIC,
                                       MAT_SUBSTRATE, MAT_SUBSURFACE,
                                       MAT_TRANSLUCENT, MAT_UBER)


class MatParams(NamedTuple):
    """Per-hit gathered material rows."""

    type: torch.Tensor      # (N,) i32
    kd: torch.Tensor        # (N,3)
    ks: torch.Tensor
    kr: torch.Tensor
    kt: torch.Tensor
    alpha_x: torch.Tensor   # (N,) remapped roughness
    alpha_y: torch.Tensor
    eta: torch.Tensor       # (N,3)
    k: torch.Tensor         # (N,3)
    sigma_a: torch.Tensor   # (N,) oren-nayar A
    sigma_b: torch.Tensor   # (N,) oren-nayar B
    extra: torch.Tensor     # (N,12) material-specific scalars (flatten.py)
    rough: torch.Tensor     # (N,) unremapped roughness (disney/hair)
    h: torch.Tensor         # (N,) hair fiber offset in [-1,1] (from uv.y)
    mix_a: object = None    # child MatParams when the scene has mix materials
    mix_b: object = None
    fourier: object = None  # the shared Fourier table (materials/fourier.py)


class BsdfSample(NamedTuple):
    wi: torch.Tensor        # (N,3) local
    f: torch.Tensor         # (N,3)
    pdf: torch.Tensor       # (N,)
    specular: torch.Tensor  # (N,) bool — delta lobe sampled
    eta_scale: torch.Tensor  # (N,) radiance compression factor (glass RR)


def roughness_to_alpha(r):
    """materials' RoughnessToAlpha (e.g. plastic.cpp / microfacet.h)."""
    r = r.clamp_min(1e-3)
    x = torch.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x**3 + 0.000640711 * x**4


def gather_mat_params(ds, mat_id, uv=None, p=None, face=None,
                      has_textures=False, tex_width=None, tex_aniso=None,
                      tex_types=(ALL_TYPES, ALL_TYPES), has_mix=False,
                      fourier_meta=None):
    """Gather + preprocess material rows for a hit batch. With
    `has_textures` (static) and `uv` / `p` given, Kd and Ks of the rows
    that name a texture are evaluated per hit (Material::
    ComputeScatteringFunctions), at the ray-cone footprint `tex_width` /
    `tex_aniso`. `tex_types` (static) = (types of the Kd textures, types of
    the Ks textures): only those are computed, and a channel without
    textures is not looked up. `has_mix` (static) also gathers both
    children of the mix rows (MixMaterial::ComputeScatteringFunctions,
    mixmat.cpp:44, one level; the other lanes gather their own row again).
    `fourier_meta` (SceneStatics.fourier) attaches the Fourier table."""
    kw = dict(uv=uv, p=p, face=face, has_textures=has_textures,
              tex_width=tex_width, tex_aniso=tex_aniso, tex_types=tex_types,
              fourier_meta=fourier_meta)
    if has_mix:
        mp = gather_mat_params(ds, mat_id, **kw)
        is_mix = mp.type == MAT_MIX
        c1 = torch.where(is_mix, mp.extra[:, 1].detach().to(mat_id.dtype),
                         mat_id)
        c2 = torch.where(is_mix, mp.extra[:, 2].detach().to(mat_id.dtype),
                         mat_id)
        return mp._replace(mix_a=gather_mat_params(ds, c1, **kw),
                           mix_b=gather_mat_params(ds, c2, **kw))
    mrow_ints = torch.stack([ds.mat_type.to(torch.int32),
                           ds.mat_remap.to(torch.int32)], dim=1)
    mtab = torch.cat(
        [ds.mat_kd, ds.mat_ks, ds.mat_kr, ds.mat_kt, ds.mat_eta, ds.mat_k,
         ds.mat_roughness[:, None], ds.mat_urough[:, None],
         ds.mat_vrough[:, None], ds.mat_sigma[:, None],
         mrow_ints.view(torch.float32),
         ds.mat_extra], dim=1)
    # index_select, not mtab[idx]: the same rows, but its backward adds the
    # rows' cotangents with atomics, where indexing's sorts the indices and
    # sums each one's duplicates serially (a few materials, 131,072 lanes:
    # about 50 ms a gather on the H100)
    mrow = torch.index_select(mtab, 0, mat_id.long())
    m_kd, m_ks = mrow[:, 0:3], mrow[:, 3:6]
    m_kr, m_kt = mrow[:, 6:9], mrow[:, 9:12]
    m_eta, m_k = mrow[:, 12:15], mrow[:, 15:18]
    rough = mrow[:, 18]
    ur = mrow[:, 19]
    vr = mrow[:, 20]
    m_ints = mrow[:, 22:24].contiguous().view(torch.int32)
    m_type = m_ints[:, 0]
    remap = m_ints[:, 1] != 0
    m_extra = mrow[:, 24:36]
    ur = torch.where(ur >= 0.0, ur, rough)
    vr = torch.where(vr >= 0.0, vr, rough)
    ax = torch.where(remap, roughness_to_alpha(ur), ur.clamp_min(1e-3))
    ay = torch.where(remap, roughness_to_alpha(vr), vr.clamp_min(1e-3))
    sigma = torch.deg2rad(mrow[:, 21])
    s2 = sigma * sigma
    kd, ks = m_kd, m_ks
    if has_textures and uv is not None:
        tx = {k: getattr(ds, k) for k in TEX_FIELDS}
        kd_types, ks_types = tex_types
        mid = mat_id.long()

        def lookup(tid, const, types):
            val = eval_texture(tx, tid.clamp_min(0), uv, p, width=tex_width,
                               aniso=tex_aniso, face=face, types=types)
            return torch.where((tid >= 0)[:, None], val, const)

        if kd_types:
            kd = lookup(ds.mat_kd_tex[mid], m_kd, kd_types)
        if ks_types:
            ks = lookup(ds.mat_ks_tex[mid], m_ks, ks_types)
    return MatParams(
        type=m_type,
        kd=kd, ks=ks,
        kr=m_kr, kt=m_kt,
        alpha_x=ax, alpha_y=ay,
        eta=m_eta, k=m_k,
        sigma_a=1.0 - s2 / (2.0 * (s2 + 0.33)),
        sigma_b=0.45 * s2 / (s2 + 0.09),
        extra=m_extra,
        rough=rough,
        h=((-1.0 + 2.0 * uv[..., 1]).clamp(-1.0, 1.0) if uv is not None
           else torch.zeros_like(rough)),
        fourier=(dict(mu=ds.four_mu, a=ds.four_a, m=ds.four_m,
                      aoffset=ds.four_aoff, cdf=ds.four_cdf, **fourier_meta)
                 if fourier_meta is not None else None),
    )


# ------------------------------ frames -------------------------------------


def make_frame(ns):
    """Orthonormal shading frame with ns as +z."""
    t, b = coordinate_system(ns)
    return t, b, ns


def to_local(t, b, n, v):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def to_world(t, b, n, v):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


# ------------------------------ fresnel ------------------------------------


def fr_dielectric(cos_i, eta):
    """reflection.cpp FrDielectric; eta = eta_t/eta_i for cos_i > 0."""
    cos_i = cos_i.clamp(-1.0, 1.0)
    entering = cos_i > 0.0
    eta_rel = torch.where(entering, eta, 1.0 / eta.clamp_min(1e-6))
    ci = torch.abs(cos_i)
    sin2_t = (1.0 - ci * ci).clamp_min(0.0) / (eta_rel * eta_rel)
    tir = sin2_t >= 1.0
    # safe_sqrt, not sqrt(max(.,0)): TIR lanes hit sqrt(0) whose inf
    # partial turns masked-out cotangents into NaN (cam-matrix grads)
    ct = safe_sqrt(1.0 - sin2_t)
    r_par = (eta_rel * ci - ct) / (eta_rel * ci + ct).clamp_min(1e-12)
    r_perp = (ci - eta_rel * ct) / (ci + eta_rel * ct).clamp_min(1e-12)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fr_conductor(cos_i, eta, k):
    """reflection.cpp FrConductor (per RGB channel); cos_i (N,), eta/k (N,3)."""
    ci = torch.abs(cos_i).clamp(0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    # safe_sqrt: a lane with k == 0 (any non-conductor lane evaluates this
    # branch too) and t0 <= 0 takes sqrt(0), whose infinite partial turns
    # the lane's zero cotangent into NaN once the camera is differentiated
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / (t1 + t2).clamp_min(1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / (t3 + t4).clamp_min(1e-12)
    return 0.5 * (rp + rs)


def schlick(rs, cos_i):
    return rs + (1.0 - rs) * torch.pow((1.0 - cos_i).clamp_min(0.0), 5.0)[..., None]


# ------------------------- Trowbridge-Reitz --------------------------------


def tr_d(wh, ax, ay):
    """GGX normal distribution (microfacet.cpp TrowbridgeReitzDistribution::D)."""
    c2 = wh[..., 2] * wh[..., 2]
    e = wh[..., 0] ** 2 / (ax * ax) + wh[..., 1] ** 2 / (ay * ay) + c2
    denom = math.pi * ax * ay * e * e
    ok = denom > 1e-20
    return torch.where(ok, 1.0 / torch.where(ok, denom, 1.0), 0.0) \
        * torch.where(c2 > 0, 1.0, 0.0)


def tr_lambda(w, ax, ay):
    """Smith masking Lambda (microfacet.cpp TrowbridgeReitz::Lambda)."""
    c = torch.abs(w[..., 2])
    s2 = (1.0 - c * c).clamp_min(0.0)
    # directional alpha (safe_sqrt: s2 == 0 on axis-aligned lanes)
    s = safe_sqrt(s2)
    cos_phi = torch.where(s > 1e-8, w[..., 0] / s.clamp_min(1e-8), 1.0)
    sin_phi = torch.where(s > 1e-8, w[..., 1] / s.clamp_min(1e-8), 0.0)
    alpha2 = cos_phi**2 * ax * ax + sin_phi**2 * ay * ay
    tan2 = s2 / (c * c).clamp_min(1e-12)
    return 0.5 * (-1.0 + torch.sqrt((1.0 + alpha2 * tan2).clamp_min(0.0)))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_sample_wh(wo, u1, u2, ax, ay):
    """Visible-normal sampling (Heitz 2018 VNDF; microfacet.cpp
    TrowbridgeReitzSample). wo local, may have wo.z < 0."""
    flip = wo[..., 2] < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)
    vh = normalize(torch.stack(
        [ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(lensq.clamp_min(1e-20))
    t1 = torch.where(
        (lensq > 1e-18)[..., None],
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], -1),
        vh.new_tensor([1.0, 0.0, 0.0]).expand(vh.shape),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    pz = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * vh
    wh = normalize(torch.stack(
        [ax * nh[..., 0], ay * nh[..., 1], nh[..., 2].clamp_min(1e-6)], -1))
    return torch.where(flip[..., None], -wh, wh)


def tr_pdf(wo, wh, ax, ay):
    """VNDF pdf w.r.t. wh (microfacet.h Pdf with sampleVisibleArea)."""
    return (tr_d(wh, ax, ay) * tr_g1(wo, ax, ay)
            * torch.abs(dot(wo, wh)) / abs_cos_theta(wo).clamp_min(1e-8))


# ----------------------------- Beckmann ------------------------------------
# (microfacet.cpp BeckmannDistribution — the reference's second distribution;
# used by bsdftest-style validation and available to materials)


def beckmann_d(wh, ax, ay):
    c2 = wh[..., 2] * wh[..., 2]
    s2 = (1.0 - c2).clamp_min(0.0)
    tan2 = s2 / c2.clamp_min(1e-12)
    cos_phi2 = torch.where(s2 > 1e-12, wh[..., 0] ** 2 / s2.clamp_min(1e-12), 1.0)
    sin_phi2 = torch.where(s2 > 1e-12, wh[..., 1] ** 2 / s2.clamp_min(1e-12), 0.0)
    e = torch.exp(-tan2 * (cos_phi2 / (ax * ax) + sin_phi2 / (ay * ay)))
    return torch.where(c2 > 1e-12,
                     e / (math.pi * ax * ay * c2 * c2), 0.0)


def beckmann_lambda(w, ax, ay):
    c = torch.abs(w[..., 2])
    s2 = (1.0 - c * c).clamp_min(0.0)
    s = safe_sqrt(s2)
    cos_phi2 = torch.where(s > 1e-8, (w[..., 0] / s.clamp_min(1e-8)) ** 2, 1.0)
    sin_phi2 = torch.where(s > 1e-8, (w[..., 1] / s.clamp_min(1e-8)) ** 2, 0.0)
    alpha = torch.sqrt(cos_phi2 * ax * ax + sin_phi2 * ay * ay)
    abs_tan = s / c.clamp_min(1e-12)
    a = 1.0 / (alpha * abs_tan).clamp_min(1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return torch.where(a >= 1.6, 0.0, lam)


def beckmann_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + beckmann_lambda(wo, ax, ay) + beckmann_lambda(wi, ax, ay))


def beckmann_sample_wh(wo, u1, u2, ax, ay):
    """Full-distribution Beckmann sampling (isotropic log-space inversion;
    microfacet.cpp BeckmannDistribution::Sample_wh non-visible branch)."""
    log_u = torch.log((1.0 - u1).clamp_min(1e-20))
    phi = u2 * 2.0 * math.pi
    # anisotropic tangent rotation
    tan2 = -ax * ay * log_u / (
        torch.cos(phi) ** 2 * ay / ax.clamp_min(1e-12)
        + torch.sin(phi) ** 2 * ax / ay.clamp_min(1e-12))
    c = 1.0 / torch.sqrt(1.0 + tan2)
    s = safe_sqrt(1.0 - c * c)
    wh = torch.stack([s * torch.cos(phi), s * torch.sin(phi), c], -1)
    return torch.where((wo[..., 2] < 0.0)[..., None], -wh, wh)


def beckmann_pdf(wo, wh, ax, ay):
    return beckmann_d(wh, ax, ay) * torch.abs(wh[..., 2])


# ------------------------------ Disney --------------------------------------
# (materials/disney.cpp: diffuse + retro-reflection + sheen + GTR1 clearcoat
# + anisotropic GGX specular with the Disney Fresnel blend, plus the
# transmission set: specTrans microfacet transmission, thin-surface mode with
# flatness fakeSS and diffTrans Lambertian transmission). The eleven row
# scalars are extra[0:11]: metallic, sheen, sheenTint, specularTint,
# clearcoat, clearcoatGloss, anisotropic, specTrans, thin, diffTrans,
# flatness.


def _pow5(x):
    return x * x * x * x * x


def _schlick_weight(c):
    return _pow5((1.0 - c).clamp(0.0, 1.0))


def _disney_alphas(mp: MatParams):
    aspect = torch.sqrt(1.0 - 0.9 * mp.extra[..., 6])
    r2 = mp.rough * mp.rough
    return (r2 / aspect).clamp_min(0.001), (r2 * aspect).clamp_min(0.001)


def _disney_trans_alphas(mp: MatParams):
    """Transmission distribution alphas: thin surfaces use the scaled
    roughness rscaled = (0.65 eta - 0.35) rough (disney.cpp:598)."""
    thin = mp.extra[..., 8] > 0.5
    aspect = torch.sqrt(1.0 - 0.9 * mp.extra[..., 6])
    rs = (0.65 * mp.eta[..., 0] - 0.35) * mp.rough
    axs = (rs * rs / aspect).clamp_min(0.001)
    ays = (rs * rs * aspect).clamp_min(0.001)
    ax, ay = _disney_alphas(mp)
    return torch.where(thin, axs, ax), torch.where(thin, ays, ay)


def _gtr1_d(mp: MatParams, whn):
    """Clearcoat GTR1 distribution at gloss lerp(clearcoatGloss, .1, .001)."""
    gloss = (1.0 - mp.extra[..., 5]) * 0.1 + mp.extra[..., 5] * 0.001
    a2 = gloss * gloss
    c2 = whn[..., 2] * whn[..., 2]
    return (a2 - 1.0) / (math.pi * torch.log(a2.clamp_min(1e-12))
                         * (1.0 + (a2 - 1.0) * c2).clamp_min(1e-12))


def _disney_f(mp: MatParams, wo, wi):
    """Sum of the Disney lobes (disney.cpp DisneyDiffuse / DisneyRetro /
    DisneySheen / DisneyClearcoat / MicrofacetReflection with
    DisneyFresnel, and the transmission side)."""
    metallic = mp.extra[..., 0]
    sheen_w = mp.extra[..., 1]
    sheen_tint = mp.extra[..., 2]
    spec_tint = mp.extra[..., 3]
    clearcoat = mp.extra[..., 4]
    eta1 = mp.eta[..., 0]
    c = mp.kd
    lum = _lum3(c).clamp_min(1e-8)
    ctint = c / lum[..., None]

    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    whn = wh / wh_len[..., None]
    cos_d = dot(wi, whn)  # cosThetaD

    fo = _schlick_weight(co)
    fi = _schlick_weight(ci)

    strans = mp.extra[..., 7]
    thin = mp.extra[..., 8] > 0.5
    dt = 0.5 * mp.extra[..., 9]  # disney.cpp: dt = diffTrans / 2
    flat = mp.extra[..., 10]

    # diffuse (Fresnel-weighted, no retro) + retro-reflection
    diff = c * (INV_PI * (1.0 - fo / 2.0) * (1.0 - fi / 2.0))[..., None]
    rr = 2.0 * mp.rough * cos_d * cos_d
    retro = c * (INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
    # thin-surface fake subsurface (disney.cpp DisneyFakeSS)
    fss90 = cos_d * cos_d * mp.rough
    fss = (1.0 + (fss90 - 1.0) * fo) * (1.0 + (fss90 - 1.0) * fi)
    ss = 1.25 * (fss * (1.0 / (ci + co).clamp_min(1e-6) - 0.5) + 0.5)
    fake = c * (INV_PI * ss)[..., None]
    diff_term = torch.where(
        thin[..., None],
        ((1.0 - flat) * (1.0 - dt))[..., None] * diff
        + (flat * (1.0 - dt))[..., None] * fake,
        diff)
    # sheen
    csheen = (1.0 - sheen_tint)[..., None] + sheen_tint[..., None] * ctint
    sheen = sheen_w[..., None] * csheen * _schlick_weight(cos_d)[..., None]
    diffuse_all = (((1.0 - metallic) * (1.0 - strans))[..., None]
                   * (diff_term + retro + sheen))

    # specular: GGX aniso with Disney Fresnel (dielectric <-> schlick blend)
    ax, ay = _disney_alphas(mp)
    r0 = ((eta1 - 1.0) / (eta1 + 1.0)) ** 2
    cspec0 = (r0 * (1.0 - metallic))[..., None] * (
        (1.0 - spec_tint)[..., None] + spec_tint[..., None] * ctint) \
        + metallic[..., None] * c
    fr_d = fr_dielectric(cos_d, eta1)[..., None]
    f_schlick = cspec0 + (1.0 - cspec0) * _schlick_weight(cos_d)[..., None]
    F = (1.0 - metallic)[..., None] * fr_d + metallic[..., None] * f_schlick
    d_spec = tr_d(whn, ax, ay)
    g_spec = tr_g(wo, wi, ax, ay)
    spec = F * (d_spec * g_spec / (4.0 * ci * co).clamp_min(1e-8))[..., None]

    # clearcoat: GTR1 with fixed F0 = 0.04 and Smith G(0.25)
    dcc = _gtr1_d(mp, whn)
    fcc = 0.04 + 0.96 * _schlick_weight(cos_d)
    gcc = (1.0 / (1.0 + tr_lambda(wo, 0.25, 0.25))
           * 1.0 / (1.0 + tr_lambda(wi, 0.25, 0.25)))
    cc = (clearcoat * 0.25 * dcc * fcc * gcc
          / (4.0 * ci * co).clamp_min(1e-8))[..., None]

    ok = (ci > 1e-6) & (co > 1e-6) & (wh_len > 1e-8) & same_hemisphere(wo, wi)
    refl_f = torch.where(ok[..., None], diffuse_all + spec + cc, 0.0)

    # transmission side (disney.cpp:593-607): specTrans microfacet
    # transmission (T = strans * sqrt(c); safe_sqrt keeps a zero channel's
    # partial finite) + thin diffTrans Lambertian
    T = strans[..., None] * safe_sqrt(c)
    axt, ayt = _disney_trans_alphas(mp)
    f_mft = _mf_trans_f(T, wo, wi, axt, ayt, eta1)
    f_dt = torch.where(thin, dt, 0.0)[..., None] * c * INV_PI
    trans_f = f_mft + torch.where(same_hemisphere(wo, wi)[..., None], 0.0,
                                  f_dt)
    return refl_f + trans_f


def _disney_lobe_weights(mp: MatParams):
    """Lobe-selection probabilities (wd, ws, wc, wt): the reflection trio
    scaled down by the specTrans transmission mass wt."""
    metallic = mp.extra[..., 0]
    clearcoat = mp.extra[..., 4]
    strans = mp.extra[..., 7]
    wt = 0.5 * (strans * (1.0 - metallic)).clamp(0.0, 1.0)
    wd = (1.0 - metallic) * 0.5
    wc = clearcoat.clamp(0.0, 1.0) * 0.25 * (1.0 - wd)
    ws = 1.0 - wd - wc
    keep = 1.0 - wt
    return wd * keep, ws * keep, wc * keep, wt


def _disney_pdf(mp: MatParams, wo, wi):
    """Average of the lobe pdfs with the lobe-selection weights of sample():
    diffuse / GGX VNDF / GTR1 clearcoat / transmission."""
    ax, ay = _disney_alphas(mp)
    p_diff = _cosine_pdf(wo, wi)
    p_spec = _mf_pdf(wo, wi, ax, ay)
    # GTR1 pdf (clearcoat samples the full distribution: D |cos| / (4 cos_d))
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    whn = wh / wh_len[..., None]
    dcc = _gtr1_d(mp, whn)
    p_cc = torch.where(same_hemisphere(wo, wi) & (wh_len > 1e-8),
                       dcc * torch.abs(whn[..., 2])
                       / (4.0 * torch.abs(dot(wo, whn))).clamp_min(1e-8),
                       0.0)
    wd, ws, wc, wt = _disney_lobe_weights(mp)
    # transmission-side densities (microfacet refract + thin cosine-down)
    thin = mp.extra[..., 8] > 0.5
    axt, ayt = _disney_trans_alphas(mp)
    p_mft = _mf_trans_pdf(wo, wi, axt, ayt, mp.eta[..., 0])
    p_down = torch.where(~same_hemisphere(wo, wi),
                         abs_cos_theta(wi) * INV_PI, 0.0)
    s_mf = torch.where(thin, 0.5, 1.0)
    p_trans = s_mf * p_mft + (1.0 - s_mf) * p_down
    return wd * p_diff + ws * p_spec + wc * p_cc + wt * p_trans


# --------------------------- lobe helpers ----------------------------------


def _oren_nayar_f(mp: MatParams, wo, wi):
    """reflection.cpp OrenNayar::f."""
    si = safe_sqrt(1.0 - wi[..., 2] ** 2)
    so = safe_sqrt(1.0 - wo[..., 2] ** 2)
    # cos(phi_i - phi_o)
    denom = (si * so).clamp_min(1e-8)
    cos_dphi = ((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom).clamp(-1.0, 1.0)
    max_cos = torch.where((si > 1e-4) & (so > 1e-4), cos_dphi.clamp_min(0.0), 0.0)
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    sin_alpha = torch.where(ci > co, so, si)
    tan_beta = torch.where(ci > co, si / ci.clamp_min(1e-8),
                         so / co.clamp_min(1e-8))
    return mp.kd * (INV_PI * (mp.sigma_a + mp.sigma_b * max_cos
                              * sin_alpha * tan_beta))[..., None]


def _microfacet_f(R, F, wo, wi, ax, ay):
    """MicrofacetReflection::f (reflection.cpp:429 family). F is (N,3)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    wh = wh / wh_len[..., None]
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    ok = (ci > 1e-6) & (co > 1e-6) & (wh_len > 1e-8) & same_hemisphere(wo, wi)
    f = R * F * (d * g / (4.0 * ci * co).clamp_min(1e-8))[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _mf_trans_f(T, wo, wi, ax, ay, eta_b):
    """MicrofacetTransmission::f (reflection.cpp:440, radiance mode,
    etaA=1, etaB=eta_b). T is (N,3), eta_b (N,)."""
    co = cos_theta(wo)
    ci = cos_theta(wi)
    eta = torch.where(co > 0.0, eta_b, 1.0 / eta_b.clamp_min(1e-6))
    wh = wo + wi * eta[..., None]
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    wh = wh / wh_len[..., None]
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    odh = dot(wo, wh)
    idh = dot(wi, wh)
    ok = (~same_hemisphere(wo, wi)) & (torch.abs(co) > 1e-6) \
        & (torch.abs(ci) > 1e-6) & (odh * idh < 0.0) & (wh_len > 1e-8)
    F = fr_dielectric(odh, eta_b)
    sqrt_denom = odh + eta * idh
    d = tr_d(wh, ax, ay)
    g = tr_g(wo, wi, ax, ay)
    # factor = 1/eta (radiance transport compression)
    mag = torch.abs(d * g * eta * eta * idh * odh
                  / torch.abs(ci * co * sqrt_denom * sqrt_denom).clamp_min(1e-12)) / (eta * eta).clamp_min(1e-12)
    f = T * ((1.0 - F) * mag)[..., None]
    return torch.where(ok[..., None], f, 0.0)


def _mf_trans_pdf(wo, wi, ax, ay, eta_b):
    """MicrofacetTransmission::Pdf (reflection.cpp:824): D pdf x dwh/dwi."""
    co = cos_theta(wo)
    eta = torch.where(co > 0.0, eta_b, 1.0 / eta_b.clamp_min(1e-6))
    wh = wo + wi * eta[..., None]
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    wh = wh / wh_len[..., None]
    wh = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    odh = dot(wo, wh)
    idh = dot(wi, wh)
    ok = (~same_hemisphere(wo, wi)) & (odh * idh < 0.0) & (wh_len > 1e-8)
    sqrt_denom = odh + eta * idh
    dwh_dwi = torch.abs(eta * eta * idh) \
        / (sqrt_denom * sqrt_denom).clamp_min(1e-12)
    return torch.where(ok, tr_pdf(wo, wh, ax, ay) * dwh_dwi, 0.0)


def _fresnel_blend_f(mp: MatParams, wo, wi):
    """FresnelBlend::f (reflection.cpp:479, substrate)."""
    rd, rs = mp.kd, mp.ks
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    pow5 = lambda x: x * x * x * x * x
    diffuse = (28.0 / (23.0 * math.pi)) * rd * (1.0 - rs) * (
        (1.0 - pow5(1.0 - 0.5 * ci)) * (1.0 - pow5(1.0 - 0.5 * co)))[..., None]
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    whn = wh / wh_len[..., None]
    d = tr_d(whn, mp.alpha_x, mp.alpha_y)
    spec = (d / (4.0 * torch.abs(dot(wi, whn))
                            * torch.maximum(ci, co)).clamp_min(1e-8))[..., None] \
        * schlick(rs, dot(wi, whn))
    ok = (ci > 1e-6) & (co > 1e-6) & (wh_len > 1e-8) & same_hemisphere(wo, wi)
    return torch.where(ok[..., None], diffuse + spec, 0.0)


def _cosine_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def _mf_pdf(wo, wi, ax, ay):
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh).clamp_min(1e-20))
    whn = wh / wh_len[..., None]
    p = tr_pdf(wo, whn, ax, ay) / (4.0 * torch.abs(dot(wo, whn))).clamp_min(1e-8)
    return torch.where(same_hemisphere(wo, wi) & (wh_len > 1e-8), p, 0.0)


# ------------------------------ eval/pdf -----------------------------------


def eval_pdf(mp: MatParams, wo, wi, features=frozenset(),
             mix_features=None):
    """(f, pdf) of the non-delta components, used for NEE/MIS
    (BSDF::f + BSDF::Pdf, reflection.cpp:576-640). `features`: the static
    material-family set (module docstring); a family outside it is not
    computed. `mix_features` (static): the families of the mix rows'
    children (SceneStatics.mix_features), the only ones computed for the
    children; None takes every family but "mix", as the JAX package does.
    The values differ only on lanes that are not mix lanes, whose children
    are their own rows and whose child results are not used."""
    eta1 = mp.eta[..., 0]
    refl = same_hemisphere(wo, wi)

    lam_f = mp.kd * INV_PI
    on_f = _oren_nayar_f(mp, wo, wi)
    matte_f = torch.where((mp.sigma_b > 0.0)[..., None], on_f, lam_f)
    matte_f = torch.where(refl[..., None], matte_f, 0.0)
    matte_pdf = _cosine_pdf(wo, wi)

    fr_d = fr_dielectric(dot(wo, _half(wo, wi)), eta1)
    plastic_f = torch.where(
        refl[..., None],
        mp.kd * INV_PI + _microfacet_f(
            mp.ks, fr_d[..., None], wo, wi, mp.alpha_x, mp.alpha_y),
        0.0)
    plastic_pdf = 0.5 * (matte_pdf + _mf_pdf(wo, wi, mp.alpha_x, mp.alpha_y))

    metal_F = fr_conductor(dot(wo, _half(wo, wi)), mp.eta, mp.k)
    metal_f = _microfacet_f(torch.ones_like(mp.kd), metal_F, wo, wi,
                            mp.alpha_x, mp.alpha_y)
    metal_pdf = _mf_pdf(wo, wi, mp.alpha_x, mp.alpha_y)

    sub_f = _fresnel_blend_f(mp, wo, wi)
    sub_pdf = plastic_pdf

    # uber (uber.cpp): opacity-scaled Kd diffuse + Ks microfacet, with Kr/Kt
    # delta lobes and the (1-op) pass-through handled in sample(); the
    # sampleable-density mixture divides by the per-lane component count.
    op = mp.extra[..., 7].clamp(0.0, 1.0)
    op = torch.where(mp.type == MAT_UBER, op, 1.0)  # slot 7 is per-type
    n_uber = (2.0 + (_lum3(mp.kr) > 0.0) + (_lum3(mp.kt) > 0.0)
              + (op < 1.0))
    uber_f = op[..., None] * plastic_f
    uber_pdf = (matte_pdf + _mf_pdf(wo, wi, mp.alpha_x, mp.alpha_y)) / n_uber

    # translucent (translucent.cpp): reflect/transmit-scaled Lambertian AND
    # microfacet lobes on both sides (FresnelDielectric(1, eta) reflection,
    # MicrofacetTransmission(ks*t, 1, eta) transmission)
    fr_t = fr_dielectric(dot(wo, _half(wo, wi)), eta1)
    mfr = _microfacet_f(mp.ks * mp.kr, fr_t[..., None], wo, wi,
                        mp.alpha_x, mp.alpha_y)
    mft = _mf_trans_f(mp.ks * mp.kt, wo, wi, mp.alpha_x, mp.alpha_y, eta1)
    trans_refl = mp.kd * mp.kr * INV_PI + mfr
    trans_trans = mp.kd * mp.kt * INV_PI + mft
    transl_f = torch.where(refl[..., None], trans_refl, trans_trans)
    transl_pdf = 0.25 * (abs_cos_theta(wi) * INV_PI
                         + _mf_pdf(wo, wi, mp.alpha_x, mp.alpha_y)
                         + _mf_trans_pdf(wo, wi, mp.alpha_x, mp.alpha_y,
                                         eta1))

    t = mp.type
    f = torch.zeros_like(mp.kd)
    pdf = torch.zeros_like(matte_pdf)
    lobes = [
        (MAT_MATTE, matte_f, matte_pdf),
        (MAT_PLASTIC, plastic_f, plastic_pdf),
        (MAT_METAL, metal_f, metal_pdf),
        (MAT_UBER, uber_f, uber_pdf),
        (MAT_SUBSTRATE, sub_f, sub_pdf),
        (MAT_TRANSLUCENT, transl_f, transl_pdf),
    ]
    if "disney" in features:
        lobes.append((MAT_DISNEY, _disney_f(mp, wo, wi),
                      _disney_pdf(mp, wo, wi)))
    if "hair" in features:
        hf, hp = hair_f_pdf(mp, wo, wi)
        lobes.append((MAT_HAIR, hf, hp))
    if "fourier" in features and mp.fourier is not None:
        # importance-sampling pdf from the table's marginal cdf (matches
        # fourier_sample; FourierBSDF::Pdf, reflection.cpp:573)
        lobes.append((MAT_FOURIER, fourier_f(mp.fourier, wo, wi),
                      fourier_pdf(mp.fourier, wo, wi)))
    for tid, tf, tp in lobes:
        sel = t == tid
        f = torch.where(sel[..., None], tf, f)
        pdf = torch.where(sel, tp, pdf)
    if "mix" in features and mp.mix_a is not None:
        # MixMaterial: amount-scaled sum of the children's BxDFs
        # (mixmat.cpp:44-60); the pdf mixes by the amount's luminance
        sub = features - {"mix"} if mix_features is None else mix_features
        f1, p1 = eval_pdf(mp.mix_a, wo, wi, sub)
        f2, p2 = eval_pdf(mp.mix_b, wo, wi, sub)
        amt = mp.kd
        q = mp.extra[..., 0]
        sel = t == MAT_MIX
        f = torch.where(sel[..., None], amt * f1 + (1.0 - amt) * f2, f)
        pdf = torch.where(sel, q * p1 + (1.0 - q) * p2, pdf)
    # mirror/glass/none/subsurface: delta only -> f = 0, pdf = 0
    return f, pdf


def _half(wo, wi):
    wh = wo + wi
    return wh / torch.sqrt(dot(wh, wh).clamp_min(1e-20))[..., None]


def _lum3(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


# ------------------------------ sampling -----------------------------------


def sample(mp: MatParams, wo, u_lobe, u1, u2, features=frozenset(),
           mix_features=None, non_delta=True):
    """BSDF::Sample_f counterpart: (BsdfSample). All local-frame.
    `features`, `mix_features`: the static material-family sets, as in
    eval_pdf. `non_delta=False` leaves out the non-delta f / pdf (zeros
    there): a mix reads its chosen child's f / pdf only where the child
    sampled a delta lobe."""
    n = wo.shape[0]
    ones = wo.new_ones(n)
    zeros = wo.new_zeros(n)
    eta1 = mp.eta[..., 0]
    sign_o = torch.where(cos_theta(wo) >= 0.0, 1.0, -1.0)

    # --- candidate 1: cosine-hemisphere diffuse direction (wo hemisphere)
    wi_diff = cosine_sample_hemisphere(u1, u2)
    wi_diff = wi_diff * torch.stack(
        [ones, ones, sign_o], -1)

    # --- candidate 2: VNDF microfacet reflection
    wh = tr_sample_wh(wo, u1, u2, mp.alpha_x, mp.alpha_y)
    wi_mf = -wo + 2.0 * dot(wo, wh)[..., None] * wh

    # --- candidate 3: perfect mirror
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)

    # --- candidate 4: refraction through z plane
    # eta ratio: entering (wo.z>0) -> 1/eta ; exiting -> eta
    entering = cos_theta(wo) > 0.0
    eta_ratio = torch.where(entering, 1.0 / eta1.clamp_min(1e-6), eta1)
    nz = torch.stack([zeros, zeros, sign_o], -1)
    cos_i = torch.abs(cos_theta(wo))
    sin2_t = eta_ratio * eta_ratio * (1.0 - cos_i * cos_i).clamp_min(0.0)
    tir = sin2_t >= 1.0
    cos_t = safe_sqrt(1.0 - sin2_t)
    wi_refr = eta_ratio[..., None] * (-wo) + (eta_ratio * cos_i - cos_t)[..., None] * nz

    # ---------------- per-material assembly ----------------
    t = mp.type
    pick2 = u_lobe < 0.5  # two-lobe materials: diffuse vs glossy

    # MATTE
    matte = dict(wi=wi_diff, spec=wo.new_zeros(n, dtype=torch.bool))

    # PLASTIC: choose diffuse or microfacet
    wi_pl = torch.where(pick2[..., None], wi_diff, wi_mf)
    # SUBSTRATE same selection
    # METAL: always microfacet
    # MIRROR
    # GLASS: Fresnel choice
    F_glass = fr_dielectric(cos_theta(wo), eta1)
    choose_refl = u_lobe < F_glass
    wi_glass = torch.where(choose_refl[..., None], wi_mirror, wi_refr)

    # UBER (uber.cpp): uniform pick among the present components
    # kd / ks / Kr / Kt / (1-op) pass-through, as BSDF::Sample_f does
    op_u = mp.extra[..., 7].clamp(0.0, 1.0)
    has_kr_u = _lum3(mp.kr) > 0.0
    has_kt_u = _lum3(mp.kt) > 0.0
    has_op_u = op_u < 1.0
    n_u = 2.0 + has_kr_u + has_kt_u + has_op_u
    cu = u_lobe * n_u  # component coordinate in [0, n)
    b_kr = 2.0 + has_kr_u
    b_kt = b_kr + has_kt_u
    uber_kd = cu < 1.0
    uber_ks = (cu >= 1.0) & (cu < 2.0)
    uber_kr = (cu >= 2.0) & (cu < b_kr)
    uber_kt = (cu >= b_kr) & (cu < b_kt)
    uber_op = cu >= b_kt
    wi_none = -wo
    wi_uber = torch.where(uber_kd[..., None], wi_diff,
                        torch.where(uber_ks[..., None], wi_mf,
                                  torch.where(uber_kr[..., None], wi_mirror,
                                            torch.where(uber_kt[..., None],
                                                      wi_refr, wi_none))))

    # TRANSLUCENT (translucent.cpp): 4-way uniform pick — diffuse
    # reflection / diffuse transmission / microfacet reflection /
    # microfacet transmission (refract about a VNDF half-vector)
    wi_down_t = wi_diff * wo.new_tensor([1.0, 1.0, -1.0])
    ci_w = dot(wo, wh)  # wh from the shared VNDF draw (wo-side oriented)
    sin2_w = eta_ratio * eta_ratio * (1.0 - ci_w * ci_w).clamp_min(0.0)
    tir_w = sin2_w >= 1.0
    ct_w = safe_sqrt(1.0 - sin2_w)
    wi_mft = (-eta_ratio[..., None] * wo
              + (eta_ratio * ci_w - ct_w)[..., None] * wh)
    tr_b = torch.floor(u_lobe.clamp(0.0, 0.999999) * 4.0)
    wi_tr = torch.where((tr_b == 0)[..., None], wi_diff,
                      torch.where((tr_b == 1)[..., None], wi_down_t,
                                torch.where((tr_b == 2)[..., None],
                                          wi_mf, wi_mft)))

    wi_cands = [
        (MAT_PLASTIC, wi_pl, False),
        (MAT_UBER, wi_uber, False),
        (MAT_SUBSTRATE, wi_pl, False),
        (MAT_METAL, wi_mf, False),
        (MAT_MIRROR, wi_mirror, True),
        (MAT_GLASS, wi_glass, True),
        (MAT_TRANSLUCENT, wi_tr, False),
        (MAT_NONE, wi_none, True),
    ]
    if "sss" in features:
        wi_cands += [(MAT_SUBSURFACE, wi_glass, True),
                     (MAT_KDSUBSURFACE, wi_glass, True)]
    if "disney" in features:
        # lobe choice: diffuse / GGX-aniso VNDF / GTR1 clearcoat /
        # transmission
        dax, day = _disney_alphas(mp)
        wh_d = tr_sample_wh(wo, u1, u2, dax, day)
        wi_dspec = -wo + 2.0 * dot(wo, wh_d)[..., None] * wh_d
        gloss = (1.0 - mp.extra[..., 5]) * 0.1 + mp.extra[..., 5] * 0.001
        a2 = (gloss * gloss).clamp_min(1e-8)
        ct2 = (1.0 - torch.pow(a2, 1.0 - u1)) / (1.0 - a2).clamp_min(1e-6)
        ct = torch.sqrt(ct2.clamp(0.0, 1.0))
        st = safe_sqrt(1.0 - ct * ct)
        phi_cc = 2.0 * math.pi * u2
        wh_cc = torch.stack([st * torch.cos(phi_cc), st * torch.sin(phi_cc),
                             ct], -1)
        wh_cc = torch.where((cos_theta(wo) < 0)[..., None], -wh_cc, wh_cc)
        wi_cc = -wo + 2.0 * dot(wo, wh_cc)[..., None] * wh_cc
        # transmission: refract about a VNDF half-vector drawn from the
        # (thin-scaled) transmission distribution; thin surfaces split
        # half / half with the diffTrans cosine-down lobe (disney.cpp:593+)
        daxt, dayt = _disney_trans_alphas(mp)
        wh_t = tr_sample_wh(wo, u1, u2, daxt, dayt)  # wo-side oriented
        eta_rt = torch.where(cos_theta(wo) > 0.0,
                             1.0 / eta1.clamp_min(1e-6), eta1)
        ci_t = dot(wo, wh_t)
        sin2_tt = eta_rt * eta_rt * (1.0 - ci_t * ci_t).clamp_min(0.0)
        tir_t = sin2_tt >= 1.0
        ct_t = safe_sqrt(1.0 - sin2_tt)
        wi_refr_t = (-eta_rt[..., None] * wo
                     + (eta_rt * ci_t - ct_t)[..., None] * wh_t)
        thin_d = mp.extra[..., 8] > 0.5
        wd, ws, wc, wt = _disney_lobe_weights(mp)
        b3 = wd + ws + wc
        u_t = (u_lobe - b3) / wt.clamp_min(1e-8)
        pick_down = thin_d & (u_t >= 0.5)
        wi_trans = torch.where(pick_down[..., None], wi_down_t, wi_refr_t)
        wi_disney = torch.where(
            (u_lobe < wd)[..., None], wi_diff,
            torch.where((u_lobe < wd + ws)[..., None], wi_dspec,
                        torch.where((u_lobe < b3)[..., None], wi_cc,
                                    wi_trans)))
        # dead samples, as in the reference: each BxDF::Sample_f returns 0
        # when its wi lands in the wrong hemisphere, and a failed Refract
        # (TIR) kills the sample (reflection.h:520); their density is not in
        # the pdf
        intend_trans = u_lobe >= b3
        disney_kill = (intend_trans & ~pick_down & tir_t) \
            | (intend_trans == same_hemisphere(wo, wi_disney))
        wi_cands.append((MAT_DISNEY, wi_disney, False))
    if "hair" in features:
        wi_cands.append((MAT_HAIR, hair_sample(mp, wo, u_lobe, u1, u2),
                         False))
    if "fourier" in features and mp.fourier is not None:
        wi_cands.append((MAT_FOURIER, fourier_sample(mp.fourier, wo, u1, u2),
                         False))
    if "mix" in features and mp.mix_a is not None:
        q = mp.extra[..., 0]
        pick1 = u_lobe < q
        u_re = torch.where(pick1, u_lobe / q.clamp_min(1e-8),
                           (u_lobe - q) / (1.0 - q).clamp_min(1e-8))
        sub = features - {"mix"} if mix_features is None else mix_features
        s1 = sample(mp.mix_a, wo, u_re, u1, u2, sub, non_delta=False)
        s2 = sample(mp.mix_b, wo, u_re, u1, u2, sub, non_delta=False)
        wi_cands.append((MAT_MIX, torch.where(pick1[..., None], s1.wi, s2.wi),
                         False))
    wi = wi_diff
    specular = wo.new_zeros(n, dtype=torch.bool)
    for tid, w, sflag in wi_cands:
        sel = t == tid
        wi = torch.where(sel[..., None], w, wi)
        specular = torch.where(sel, sflag, specular)
    # DETACHED-SAMPLING estimator (SURVEY.md §7 step 7): the sampled
    # direction is a constant of differentiation — f below is evaluated at
    # this fixed wi and differentiated w.r.t. material params only. This
    # also severs the inverse-CDF sqrt/log chains whose cotangents are
    # inf-at-0 (NaN-safe roughness gradients).
    wi = normalize(wi).detach()

    # non-delta materials: f/pdf via eval
    if non_delta:
        f_nd, pdf_nd = eval_pdf(mp, wo, wi, features, mix_features)
    else:
        f_nd, pdf_nd = torch.zeros_like(mp.kd), wo.new_zeros(n)

    # delta materials: explicit f/pdf
    aci = abs_cos_theta(wi).clamp_min(1e-8)
    f_mirror = mp.kr / aci[..., None]  # mirror uses FresnelNoOp (mirror.cpp:46)
    pdf_mirror = ones

    # glass reflect: F * kr / |cos|; transmit: (1-F) * kt * (1/eta_ratio^2) / |cos|
    f_glass_refl = mp.kr * (F_glass / aci)[..., None]
    # radiance transport carries the eta^2 compression (reflection.h:324
    # SpecularTransmission, mode==Radiance)
    f_glass_trans = mp.kt * (((1.0 - F_glass) * eta_ratio * eta_ratio) / aci)[..., None]
    f_glass = torch.where(choose_refl[..., None], f_glass_refl,
                        torch.where(tir[..., None], 0.0, f_glass_trans))
    pdf_glass = torch.where(choose_refl, F_glass, 1.0 - F_glass)

    f_none = wo.new_ones((n, 3)) / aci[..., None]
    pdf_none = ones

    f = f_nd
    pdf = pdf_nd
    if "disney" in features:
        dead = (t == MAT_DISNEY) & disney_kill
        f = torch.where(dead[..., None], 0.0, f)
        pdf = torch.where(dead, 0.0, pdf)
    deltas = [(MAT_MIRROR, f_mirror, pdf_mirror),
              (MAT_GLASS, f_glass, pdf_glass),
              (MAT_NONE, f_none, pdf_none)]
    if "sss" in features:
        # subsurface interface: Fresnel specular reflect / enter-the-medium
        # split with unit transmit throughput (the BSSRDF exit sampling in
        # the integrator supplies the S-weight; materials/subsurface.cpp
        # attaches a specular interface the same way)
        f_sss = torch.where(choose_refl[..., None],
                            (F_glass / aci)[..., None] * wo.new_ones((n, 3)),
                            ((1.0 - F_glass) / aci)[..., None]
                            * wo.new_ones((n, 3)))
        deltas += [(MAT_SUBSURFACE, f_sss, pdf_glass),
                   (MAT_KDSUBSURFACE, f_sss, pdf_glass)]
    for tid, tf, tp in deltas:
        sel = t == tid
        f = torch.where(sel[..., None], tf, f)
        pdf = torch.where(sel, tp, pdf)

    # uber delta components (uber.cpp: Kr SpecularReflection with
    # FresnelDielectric, Kt SpecularTransmission(kt, 1, e), and the (1-op)
    # pass-through SpecularTransmission(1-op, 1, 1))
    is_uber = t == MAT_UBER
    inv_nu = 1.0 / n_u
    f_u_kr = op_u[..., None] * mp.kr * (F_glass / aci)[..., None]
    f_u_kt = op_u[..., None] * mp.kt * (
        ((1.0 - F_glass) * eta_ratio * eta_ratio) / aci)[..., None]
    f_u_kt = torch.where(tir[..., None], 0.0, f_u_kt)
    f_u_op = ((1.0 - op_u) / aci)[..., None] * wo.new_ones((n, 3))
    for cond, tf in ((uber_kr, f_u_kr), (uber_kt, f_u_kt),
                     (uber_op, f_u_op)):
        sel = is_uber & cond
        f = torch.where(sel[..., None], tf, f)
        pdf = torch.where(sel, inv_nu, pdf)
        specular = torch.where(sel, True, specular)

    # translucent: kill microfacet samples that landed in the wrong
    # hemisphere (each BxDF::Sample_f returns 0 there) or hit TIR on the
    # transmission refract — their density is not in transl_pdf
    tr_kill = (t == MAT_TRANSLUCENT) & (
        ((tr_b == 2) & ~same_hemisphere(wo, wi))
        | ((tr_b == 3) & (same_hemisphere(wo, wi) | tir_w)))
    f = torch.where(tr_kill[..., None], 0.0, f)
    pdf = torch.where(tr_kill, 0.0, pdf)

    if "mix" in features and mp.mix_a is not None:
        # the chosen mix child sampled a delta lobe: one-sample estimator
        # with the child's own f / pdf, amount-scaled (ScaledBxDF,
        # reflection.h:130)
        amt_c = torch.where(pick1[..., None], mp.kd, 1.0 - mp.kd)
        q_c = torch.where(pick1, q, 1.0 - q)
        f_c = torch.where(pick1[..., None], s1.f, s2.f)
        pdf_c = torch.where(pick1, s1.pdf, s2.pdf)
        spec_c = torch.where(pick1, s1.specular, s2.specular)
        sel = (t == MAT_MIX) & spec_c
        f = torch.where(sel[..., None], amt_c * f_c, f)
        pdf = torch.where(sel, q_c * pdf_c, pdf)
        specular = torch.where(sel, True, specular)

    # eta_scale for russian roulette (path.cpp:193-199): cancels the eta^2
    # radiance compression in beta so RR sees the undistorted throughput —
    # i.e. the INVERSE of the 1/eta_rel^2-style factor baked into f.
    is_glass_trans = (t == MAT_GLASS) & ~choose_refl & ~tir
    # uber Kt and translucent microfacet-transmission lanes carry the same
    # eta^2 compression in f; the pass-through (1-op) lobe has eta = 1
    is_utrans = is_uber & uber_kt & ~tir
    is_ttrans = (t == MAT_TRANSLUCENT) & (tr_b == 3) & ~tir_w \
        & ~same_hemisphere(wo, wi)
    eta_scale = torch.where(
        is_glass_trans | is_utrans | is_ttrans,
        1.0 / (eta_ratio * eta_ratio).clamp_min(1e-12), 1.0)
    if "disney" in features:
        # disney specTrans refraction carries the same eta^2 compression
        # (thin surfaces net out to 1: light exits the far side)
        is_dtrans = ((t == MAT_DISNEY) & (u_lobe >= b3) & ~pick_down
                     & ~tir_t & ~thin_d)
        eta_scale = torch.where(
            is_dtrans, 1.0 / (eta_rt * eta_rt).clamp_min(1e-12), eta_scale)
    if "mix" in features and mp.mix_a is not None:
        eta_scale = torch.where(t == MAT_MIX,
                                torch.where(pick1, s1.eta_scale,
                                            s2.eta_scale), eta_scale)
    # detached estimator: the sampling DENSITY in the denominator (and the
    # MIS weights built from it) is detached along with the direction; only
    # f carries parameter cotangents
    return BsdfSample(wi=wi, f=f, pdf=pdf.detach(),
                      specular=specular,
                      eta_scale=eta_scale.detach())
