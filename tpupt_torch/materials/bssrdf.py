"""Separable BSSRDF: exit-point sampling for subsurface materials
(counterpart of core/bssrdf.{h,cpp} TabulatedBSSRDF + its probe-ray
sampling, bssrdf.cpp:130-240).

The radial profile is the tabulated beam-diffusion one (`sss_pack`, built
at upload from materials/bssrdf_table.py, bssrdf.cpp:145) when the scene
carries the table, else the analytic two-exponential Burley approximation

    Sp(r) = rho * (e^{-r/d} + e^{-r/(3d)}) / (8 pi d r)

whose radial CDF 1 - e^{-r/d}/4 - 3 e^{-r/(3d)}/4 is inverted by bisection,
per channel. The probe ray descends the shading normal from a disk point at
the sampled radius and accepts the first hit carrying the same material
(the reference's intersection chain, bssrdf.cpp:170-214, keeps a list; one
probe is the single-sample version). The probe goes through the caller's
traversal, which detaches its inputs: the exit point's gradient comes from
the probe's origin and direction with the hit distance held fixed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpupt_torch.core import rng
from tpupt_torch.core.vecmath import coordinate_system
from tpupt_torch.materials.bsdf import fr_dielectric

INV_8PI = 1.0 / (8.0 * math.pi)
_RADIUS0 = 2.5e-3          # shared optical radius grid (bssrdf.cpp:664)
# log 1.2 in float32, as the JAX package takes it
_LOG_RATIO = float(np.log(np.float32(1.2)))


def burley_profile(r, d):
    """Area-measure normalized Sp/rho (unit integral over the plane)."""
    d = d.clamp_min(1e-6)
    r = r.clamp_min(1e-6)
    return (torch.exp(-r / d) + torch.exp(-r / (3.0 * d))) * INV_8PI / (d * r)


def burley_cdf(r, d):
    d = d.clamp_min(1e-6)
    return 1.0 - 0.25 * torch.exp(-r / d) - 0.75 * torch.exp(-r / (3.0 * d))


def burley_sample_r(u, d):
    """Invert the radial CDF by bisection (24 steps cover float32)."""
    d = d.clamp_min(1e-6)
    lo = torch.zeros_like(d)
    hi = 40.0 * d
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        below = burley_cdf(mid, d) < u
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def fresnel_moment1(inv_eta):
    """First Fresnel moment polynomial (bssrdf.cpp FresnelMoment1)."""
    e = inv_eta
    e2 = e * e
    e3 = e2 * e
    e4 = e3 * e
    e5 = e4 * e
    lo = (0.45966 - 1.73965 * e + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * e - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(e < 1.0, lo, hi)


def _take(x, idx):
    """x[i, idx[i]] for a (N, K) x and an (N,) index."""
    return x.gather(1, idx.long()[:, None])[:, 0]


def _tab_profile_eval(P, r_opt):
    """Interpolate the per-lane (N, 64) profile rows at optical radius
    r_opt (N,). The grid is geometric (r_j = 2.5e-3 * 1.2^(j-1), r_0 = 0),
    so the bracketing index is a log, not a search."""
    j = 1.0 + torch.log(r_opt.clamp_min(_RADIUS0) / _RADIUS0) / _LOG_RATIO
    j = j.clamp(0.0, 62.999)
    j0 = j.to(torch.int32)
    w = j - j0.to(torch.float32)
    p0 = _take(P, j0)
    p1 = _take(P, j0 + 1)
    lo = r_opt < _RADIUS0  # first segment is [0, 2.5e-3], linear in r
    w = torch.where(lo, r_opt / _RADIUS0, w)
    p0 = torch.where(lo, P[:, 0], p0)
    return (1.0 - w) * p0 + w * p1


def tabulated_sample_weight(ds, mat_id, ch, u_r):
    """(r, w_profile_rgb) from the tabulated beam-diffusion profile
    (TabulatedBSSRDF::Sr / Sample_Sr, bssrdf.cpp:277-340): one packed row
    gather per lane; radius from the per-channel piecewise-linear inverse
    cdf; the channel-MIS weight is Sp_rgb / mean_c(Sp_c / rho_eff_c), area-
    measure densities as on the Burley path."""
    row = ds.sss_pack[mat_id.long()]
    sig_t = row[:, 0:3].clamp_min(1e-6)
    rho_eff = row[:, 3:6].clamp_min(1e-6)
    P = row[:, 6:198].reshape(-1, 3, 64)
    inv = row[:, 198:390].reshape(-1, 3, 64)
    inv_c = inv.gather(1, ch.long()[:, None, None].expand(-1, 1, 64))[:, 0]
    f = u_r.clamp(0.0, 1.0 - 1e-6) * 63.0
    j0 = f.to(torch.int32)
    w = f - j0.to(torch.float32)
    r_opt_c = (1.0 - w) * _take(inv_c, j0) + w * _take(inv_c, j0 + 1)
    r = (r_opt_c / _take(sig_t, ch)).clamp_min(1e-6)
    # Sp_c(r) = sigma_t_c * P_c(sigma_t_c r) / (2 pi r)  (area measure)
    sp_rgb = torch.stack(
        [sig_t[:, c] * _tab_profile_eval(P[:, c, :], r * sig_t[:, c])
         for c in range(3)], -1) / (2.0 * math.pi * r[:, None])
    pdf_mix = torch.mean(sp_rgb / rho_eff, -1)
    return r, sp_rgb / pdf_mix.clamp_min(1e-20)[:, None]


def sss_exit(ds, st, mp, sp, entered, key, intersect, shade):
    """Sample a BSSRDF exit VERTEX for the lanes that transmitted into a
    subsurface material (Sample_Sp, bssrdf.cpp:158-230). `intersect(o, d,
    tmax)` is the caller's closest-hit traversal, `shade(hit, o, d)` its
    ShadingPoint assembly. Returns (p_exit, n_exit, w_profile_rgb, c_norm,
    ok); the caller runs NEE and the Sw exit lobe at the vertex, as
    path.cpp:167-189 does."""
    u_ch = rng.uniform_float(key, 101)
    u_r = rng.uniform_float(key, 102)
    u_phi = rng.uniform_float(key, 103)

    d_rgb = mp.extra[:, 0:3].clamp_min(1e-6)
    ch = (u_ch * 3.0).to(torch.int32).clamp_max(2)
    if st.has_bssrdf_table:
        r, w_profile = tabulated_sample_weight(ds, sp.mat, ch, u_r)
    else:
        r = burley_sample_r(u_r, _take(d_rgb, ch))
        # channel-MIS profile weight: Sp_rgb(r) / mean_c pdf_c(r)
        prof_rgb = burley_profile(r[:, None], d_rgb)
        w_profile = mp.kd * prof_rgb / torch.mean(prof_rgb, -1).clamp_min(
            1e-20)[:, None]

    # probe straight down the shading normal from a disk point at radius r
    # (single-axis version of the reference's 3-axis probe chain)
    t_f, b_f = coordinate_system(sp.ns)
    phi = 2.0 * math.pi * u_phi
    p_base = sp.p + r[:, None] * (torch.cos(phi)[:, None] * t_f
                                  + torch.sin(phi)[:, None] * b_f)
    h = r.clamp_min(1e-4)
    o_probe = p_base + h[:, None] * sp.ns
    hit = intersect(o_probe, -sp.ns,
                    torch.where(entered, 2.0 * h * 1.01, 0.0))
    spe = shade(hit, o_probe, -sp.ns)
    ok = entered & hit.valid & (spe.mat == sp.mat)
    p_exit = torch.where(ok[:, None], spe.p, sp.p)
    n_exit = torch.where(ok[:, None], spe.ns, sp.ns)

    eta1 = mp.eta[:, 0]
    c_norm = (1.0 - 2.0 * fresnel_moment1(1.0 / eta1)).clamp_min(1e-3)
    return p_exit, n_exit, w_profile, c_norm, ok


def sw_lobe(eta1, c_norm, cos_local):
    """Sw directional factor (SeparableBSSRDF::Sw, bssrdf.h:80):
    (1 - Fr(cos)) / (c * pi), a cosine-hemisphere-like exit lobe."""
    return (1.0 - fr_dielectric(cos_local, eta1)) / (c_norm * math.pi)
