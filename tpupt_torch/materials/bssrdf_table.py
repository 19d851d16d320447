"""Tabulated beam-diffusion BSSRDF (core/bssrdf.cpp:145 parity).

Host-side (numpy) computation of the reference's BSSRDFTable:
`ComputeBeamDiffusionBSSRDF` integrates the photon-beam-diffusion
multiple-scattering dipole (BeamDiffusionMS, bssrdf.cpp:199-252 —
Grosjean's non-classical diffusion coefficient, extrapolated boundary
from the Fresnel moments, exponentially sampled real-source depths) plus
the exact single-scattering term (BeamDiffusionSS, bssrdf.cpp:254-276)
over a 100-albedo x 64-radius grid of unitless (sigma_t = 1) optical
profiles, and `SubsurfaceFromDiffuse` (bssrdf.cpp:700) inverts the
effective-albedo curve to recover (sigma_a, sigma_s) from a target
diffuse color.

Deviations from the reference: the profile is evaluated with linear
interpolation over the (dense, geometric) radius grid instead of
Catmull-Rom splines, and rho_eff / the sampling CDF use trapezoid
integration instead of IntegrateCatmullRom — on this grid the difference
is far below the MC noise of a subsurface render.

Everything here is vectorized numpy run once at scene-flatten time; the
per-material rows reach the device packed as `sss_pack`
(scene/device.py). The JAX package keeps the same module; this is this
package's own copy, and the parity tests hold the two equal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np

N_RHO = 100
N_RADII = 64
_INV_4PI = 1.0 / (4.0 * np.pi)


def fresnel_moment1(eta):
    """FresnelMoment1 (bssrdf.cpp:30-44) — argument is pbrt's eta."""
    eta = np.asarray(eta, np.float64)
    e2, e3 = eta * eta, eta ** 3
    e4, e5 = eta ** 4, eta ** 5
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return np.where(eta < 1.0, lo, hi)


def fresnel_moment2(eta):
    """FresnelMoment2 (bssrdf.cpp:46-59)."""
    eta = np.asarray(eta, np.float64)
    e2, e3 = eta * eta, eta ** 3
    e4, e5 = eta ** 4, eta ** 5
    lo = (0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / np.maximum(eta, 1e-6)
    r2, r3 = r * r, r ** 3
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return np.where(eta < 1.0, lo, hi)


def _fr_dielectric(cos_i, eta_i, eta_t):
    """FrDielectric (reflection.cpp:47), numpy scalar/array form."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = np.where(entering, eta_i, eta_t)
    et = np.where(entering, eta_t, eta_i)
    ci = np.abs(cos_i)
    sin_t = ei / et * np.sqrt(np.maximum(1.0 - ci * ci, 0.0))
    tir = sin_t >= 1.0
    ct = np.sqrt(np.maximum(1.0 - sin_t * sin_t, 0.0))
    r_par = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return np.where(tir, 1.0, fr)


def _phase_hg(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return _INV_4PI * (1.0 - g * g) / np.maximum(
        denom * np.sqrt(np.maximum(denom, 1e-12)), 1e-12)


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r):
    """BeamDiffusionMS (bssrdf.cpp:199-252), vectorized over r."""
    n = 100
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1 = fresnel_moment1(eta)
    fm2 = fresnel_moment2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    r = np.asarray(r, np.float64)[None, :]
    i = np.arange(n, dtype=np.float64)[:, None]
    zr = -np.log(1.0 - (i + 0.5) / n) / sigmap_t
    zv = -zr + 2.0 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    phi_d = _INV_4PI / d_g * (np.exp(-sigma_tr * dr) / dr
                              - np.exp(-sigma_tr * dv) / dv)
    e_dn = _INV_4PI * (
        zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr ** 3
        - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv ** 3)
    e_term = phi_d * c_phi + e_dn * c_e
    kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
    return np.mean(kappa * rhop * rhop * e_term, axis=0)


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r):
    """BeamDiffusionSS (bssrdf.cpp:254-276), vectorized over r."""
    n = 100
    sigma_t = sigma_a + sigma_s
    rho = sigma_s / sigma_t
    r = np.asarray(r, np.float64)[None, :]
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = np.arange(n, dtype=np.float64)[:, None]
    ti = t_crit - np.log(1.0 - (i + 0.5) / n) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cos_o = ti / np.maximum(d, 1e-12)
    ess = (rho * np.exp(-sigma_t * (d + t_crit)) / np.maximum(d * d, 1e-12)
           * _phase_hg(cos_o, g)
           * (1.0 - _fr_dielectric(-cos_o, 1.0, eta)) * np.abs(cos_o))
    return np.mean(ess, axis=0)


class BSSRDFTable(NamedTuple):
    rho: np.ndarray          # (N_RHO,) single-scatter albedo samples
    radius: np.ndarray       # (N_RADII,) unitless optical radii
    profile: np.ndarray      # (N_RHO, N_RADII): 2 pi r Sr_1(r) at sigma_t=1
    cdf: np.ndarray          # (N_RHO, N_RADII) radial sampling cdf (to 1)
    rho_eff: np.ndarray      # (N_RHO,) effective (diffuse) albedo


@lru_cache(maxsize=8)
def compute_beam_diffusion_table(eta: float, g: float = 0.0) -> BSSRDFTable:
    """ComputeBeamDiffusionBSSRDF (bssrdf.cpp:662-697)."""
    radius = np.zeros(N_RADII)
    radius[1] = 2.5e-3
    for j in range(2, N_RADII):
        radius[j] = radius[j - 1] * 1.2
    i = np.arange(N_RHO, dtype=np.float64)
    rho = (1.0 - np.exp(-8.0 * i / (N_RHO - 1))) / (1.0 - np.exp(-8.0))

    profile = np.zeros((N_RHO, N_RADII))
    for k in range(N_RHO):
        rk = rho[k]
        if rk <= 0.0:
            continue
        profile[k] = 2.0 * np.pi * radius * (
            beam_diffusion_ss(rk, 1.0 - rk, g, eta, radius)
            + beam_diffusion_ms(rk, 1.0 - rk, g, eta, radius))
    # rho_eff + sampling cdf: trapezoid over the radius grid (stands in
    # for IntegrateCatmullRom; deviation documented in the module doc)
    dr = np.diff(radius)
    seg = 0.5 * (profile[:, 1:] + profile[:, :-1]) * dr[None, :]
    cdf_abs = np.concatenate(
        [np.zeros((N_RHO, 1)), np.cumsum(seg, axis=1)], axis=1)
    rho_eff = cdf_abs[:, -1].copy()
    # trapezoid overshoot on the peaked near-conservative profiles can
    # push rho_eff a couple % past the physical bound rho_eff <= rho;
    # rescale those rows so energy conservation holds exactly
    scale = np.minimum(1.0, np.maximum(rho, 1e-12)
                       / np.maximum(rho_eff, 1e-12))
    profile *= scale[:, None]
    rho_eff *= scale
    cdf = cdf_abs / np.maximum(cdf_abs[:, -1:], 1e-12)
    return BSSRDFTable(rho=rho, radius=radius, profile=profile, cdf=cdf,
                       rho_eff=rho_eff)


def subsurface_from_diffuse(table: BSSRDFTable, rho_eff_target, mfp):
    """SubsurfaceFromDiffuse (bssrdf.cpp:700-711): invert the rho ->
    rho_eff curve, then split 1/mfp into (sigma_s, sigma_a)."""
    rho_eff_target = np.clip(np.asarray(rho_eff_target, np.float64),
                             0.0, float(table.rho_eff[-1]) - 1e-6)
    rho = np.interp(rho_eff_target, table.rho_eff, table.rho)
    mfp = np.maximum(np.asarray(mfp, np.float64), 1e-6)
    sigma_s = rho / mfp
    sigma_a = (1.0 - rho) / mfp
    return sigma_a, sigma_s
