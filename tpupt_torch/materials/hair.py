"""Batched hair BSDF — the Marschner/d'Eon/Chiang fiber scattering model
(reference: src/materials/hair.{h,cpp}, pbrt-v3's HairBSDF).

Local-frame convention matches the reference: +x runs ALONG the fiber (the
curve's dpdu), so sin(thetaO) = wo.x and the azimuth lives in the (y, z)
plane (hair.cpp:141-146). The fiber offset h in [-1,1] comes from the
ribbon's v coordinate (`MatParams.h`, from uv.y: hair is attached to curve
shapes tessellated to ribbons whose v spans the width).

Lobes p = 0..2 are R / TT / TRT with a compacted p >= 3 residual
(hair.cpp:100 pMax = 3): longitudinal Mp is d'Eon's modified-Gaussian with
log-space I0 for small variance (hair.cpp:152-173), azimuthal Np is a
trimmed logistic around Phi(p) (hair.cpp:201-230), attenuation Ap tracks
Fresnel + interior absorption (hair.cpp:175-199). I0 is the reference's
ten-term series; the scale tilts are the sin / cos(2^k alpha) recurrence.
Square roots of clamped arguments take `safe_sqrt` (forward values
unchanged), so a masked lane's zero cotangent stays zero.
"""

from __future__ import annotations

import math

import torch

from tpupt_torch.core.vecmath import safe_sqrt
from tpupt_torch.scene.flatten import MAT_HAIR

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069
# beta_m, beta_n, alpha (degrees): hair.cpp CreateHairMaterial's defaults
_DEFAULT_FIBER = (0.3, 0.3, 2.0)


def _i0(x):
    """Modified Bessel I0, series (hair.cpp I0)."""
    val = torch.ones_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(1, 10):
        x2i = x2i * x * x
        ifact *= i
        i4 *= 4.0
        val = val + x2i / (i4 * ifact * ifact)
    return val


def _log_i0(x):
    """log I0 with the large-argument asymptote (hair.cpp LogI0):
    x + 0.5 * (-log(2 pi) + log(1/x) + 1/(8x)) for x > 12."""
    xs = x.clamp_min(1e-8)
    big = x + 0.5 * (-math.log(2.0 * math.pi) + torch.log(1.0 / xs)
                     + 1.0 / (8.0 * xs))
    small = torch.log(_i0(x.clamp_max(12.0)))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering (hair.cpp Mp)."""
    v = v.clamp_min(1e-5)
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = torch.exp(_log_i0(a) - b - 1.0 / v + 0.6931
                      + torch.log(1.0 / (2.0 * v)))
    large = (torch.exp(-b) * _i0(a)) / (torch.sinh(1.0 / v) * 2.0 * v)
    return torch.where(v <= 0.1, small, large)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    """hair.cpp SampleTrimmedLogistic."""
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    x = -s * torch.log(1.0 / (u * k + _logistic_cdf(a, s)).clamp_min(1e-12)
                       - 1.0)
    return x.clamp(a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _fr_dielectric(cos_i, eta):
    cos_i = cos_i.clamp(-1.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i).clamp_min(0.0) / (eta * eta)
    tir = sin2_t >= 1.0
    ct = safe_sqrt(1.0 - sin2_t)
    ci = torch.abs(cos_i)
    r_par = (eta * ci - ct) / (eta * ci + ct).clamp_min(1e-12)
    r_perp = (ci - eta * ct) / (ci + eta * ct).clamp_min(1e-12)
    return torch.where(tir, 1.0, 0.5 * (r_par ** 2 + r_perp ** 2))


class _HairCtx:
    """Per-batch derived quantities shared by f/pdf/sample."""

    def __init__(self, mp, wo):
        self.sigma_a = mp.kd                  # (N,3) absorption
        self.eta = mp.eta[..., 0]
        # lanes of other materials, whose hair result is discarded, take
        # the default fiber (their own extra[0:3] are other parameters:
        # beta_n = 0 makes the logistic NaN, and a NaN times the discarded
        # lane's zero cotangent would be NaN in the tables' gradients)
        extra = torch.where((mp.type == MAT_HAIR)[..., None],
                            mp.extra[..., 0:3],
                            mp.extra.new_tensor(_DEFAULT_FIBER))
        beta_m = extra[..., 0]
        beta_n = extra[..., 1]
        alpha = torch.deg2rad(extra[..., 2])
        self.h = mp.h
        self.gamma_o = torch.asin(self.h.clamp(-1.0, 1.0))

        # longitudinal variances (hair.cpp:232-238)
        t = 0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20
        v0 = t * t
        self.v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
        # azimuthal logistic scale (hair.cpp:242)
        self.s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n ** 2
                                   + 5.372 * beta_n ** 22)
        # scale tilts: sin/cos(2^k alpha) recurrence (hair.cpp:246-252)
        s0 = torch.sin(alpha)
        c0 = safe_sqrt(1.0 - s0 * s0)
        self.sin2k = [s0]
        self.cos2k = [c0]
        for _ in range(2):
            s_prev, c_prev = self.sin2k[-1], self.cos2k[-1]
            self.sin2k.append(2.0 * c_prev * s_prev)
            self.cos2k.append(c_prev * c_prev - s_prev * s_prev)

        self.sin_to = wo[..., 0].clamp(-1.0, 1.0)
        self.cos_to = safe_sqrt(1.0 - self.sin_to ** 2)
        self.phi_o = torch.atan2(wo[..., 2], wo[..., 1])

        # refracted geometry (hair.cpp:261-271)
        sin_tt = self.sin_to / self.eta
        self.cos_tt = safe_sqrt(1.0 - sin_tt ** 2)
        etap = torch.sqrt((self.eta ** 2 - self.sin_to ** 2).clamp_min(
            1e-12)) / self.cos_to.clamp_min(1e-6)
        sin_gt = (self.h / etap.clamp_min(1e-6)).clamp(-1.0, 1.0)
        self.cos_gt = safe_sqrt(1.0 - sin_gt ** 2)
        self.gamma_t = torch.asin(sin_gt)

        # interior transmittance (hair.cpp:274)
        self.T = torch.exp(-self.sigma_a * (
            2.0 * self.cos_gt / self.cos_tt.clamp_min(1e-6))[..., None])
        self.ap = self._ap()

    def _ap(self):
        """Attenuation per lobe (hair.cpp Ap)."""
        cos_go = safe_sqrt(1.0 - self.h ** 2)
        f = _fr_dielectric(self.cos_to * cos_go, self.eta)
        ap = [f[..., None].expand(self.T.shape)]
        ap.append(((1.0 - f) ** 2)[..., None] * self.T)
        ap.append(ap[1] * self.T * f[..., None])
        # compacted residual: Ap[2] * f*T / (1 - T*f)
        tf = self.T * f[..., None]
        ap.append(ap[2] * tf / (1.0 - tf).clamp_min(1e-4))
        return ap

    def tilted_to(self, p):
        """Scale-tilt rotated (sinThetaOp, cosThetaOp) (hair.cpp:285-300)."""
        s, c = self.sin_to, self.cos_to
        if p == 0:
            so = s * self.cos2k[1] - c * self.sin2k[1]
            co = s * self.sin2k[1] + c * self.cos2k[1]
        elif p == 1:
            so = s * self.cos2k[0] + c * self.sin2k[0]
            co = -s * self.sin2k[0] + c * self.cos2k[0]
        elif p == 2:
            so = s * self.cos2k[2] + c * self.sin2k[2]
            co = -s * self.sin2k[2] + c * self.cos2k[2]
        else:
            so, co = s, c
        return so, torch.abs(co)

    def ap_pdf(self):
        """Lobe-selection pmf from Ap luminances (hair.cpp ComputeApPdf)."""
        lum = [0.2126 * a[..., 0] + 0.7152 * a[..., 1] + 0.0722 * a[..., 2]
               for a in self.ap]
        tot = (lum[0] + lum[1] + lum[2] + lum[3]).clamp_min(1e-12)
        return [a / tot for a in lum]


def hair_f_pdf(mp, wo, wi):
    """(f, pdf) of the full hair BSDF (HairBSDF::f + ::Pdf). The reference
    folds the 1/|cos thetaI| into f (hair.cpp:304)."""
    ctx = _HairCtx(mp, wo)
    sin_ti = wi[..., 0].clamp(-1.0, 1.0)
    cos_ti = safe_sqrt(1.0 - sin_ti ** 2)
    phi = torch.atan2(wi[..., 2], wi[..., 1]) - ctx.phi_o

    f = torch.zeros_like(mp.kd)
    pdf = torch.zeros_like(sin_ti)
    ap_pdf = ctx.ap_pdf()
    for p in range(P_MAX):
        so, co = ctx.tilted_to(p)
        m = _mp(cos_ti, co, sin_ti, so, ctx.v[p])
        dphi = phi - _phi_fn(p, ctx.gamma_o, ctx.gamma_t)
        # wrap to [-pi, pi]
        dphi = torch.atan2(torch.sin(dphi), torch.cos(dphi))
        np_ = _trimmed_logistic(dphi, ctx.s, -math.pi, math.pi)
        f = f + ctx.ap[p] * (m * np_)[..., None]
        pdf = pdf + m * np_ * ap_pdf[p]
    m_last = _mp(cos_ti, ctx.cos_to, sin_ti, ctx.sin_to, ctx.v[P_MAX])
    f = f + ctx.ap[P_MAX] * (m_last / (2.0 * math.pi))[..., None]
    pdf = pdf + m_last * ap_pdf[P_MAX] / (2.0 * math.pi)
    f = f / torch.abs(wi[..., 2]).clamp_min(1e-4)[..., None]
    return f, pdf


def hair_sample(mp, wo, u0, u1, u2):
    """HairBSDF::Sample_f's direction: choose lobe p by the Ap pmf, sample
    Mp for the longitudinal angle and the trimmed logistic for the azimuth.
    The 4th uniform (azimuth) is u0 rescaled within its selected cdf
    segment (the reference demuxes two 2D samples, hair.cpp DemuxFloat).
    The caller takes f / pdf from hair_f_pdf at this wi."""
    ctx = _HairCtx(mp, wo)
    ap_pdf = ctx.ap_pdf()

    # lobe selection by cdf inversion over the 4 lobes
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_idx = ((u0 >= c0).to(torch.int32) + (u0 >= c1).to(torch.int32)
             + (u0 >= c2).to(torch.int32))
    cdf_lo = torch.where(p_idx == 0, 0.0,
                         torch.where(p_idx == 1, c0,
                                     torch.where(p_idx == 2, c1, c2)))
    pmf = torch.where(p_idx == 0, ap_pdf[0],
                      torch.where(p_idx == 1, ap_pdf[1],
                                  torch.where(p_idx == 2, ap_pdf[2],
                                              ap_pdf[3])))
    u3 = ((u0 - cdf_lo) / pmf.clamp_min(1e-8)).clamp(0.0, 1.0)

    sin_ti = torch.zeros_like(u0)
    cos_ti = torch.zeros_like(u0)
    dphi = torch.zeros_like(u0)
    for p in range(P_MAX + 1):
        so, co = ctx.tilted_to(p)
        v = ctx.v[p]
        up = u1.clamp_min(1e-5)
        cos_theta = 1.0 + v * torch.log(
            (up + (1.0 - up) * torch.exp(-2.0 / v.clamp_min(1e-5)))
            .clamp_min(1e-12))
        sin_theta = safe_sqrt(1.0 - cos_theta ** 2)
        cos_phi = torch.cos(2.0 * math.pi * u2)
        sti = -cos_theta * so + sin_theta * cos_phi * co
        cti = safe_sqrt(1.0 - sti ** 2)
        if p < P_MAX:
            dp = (_phi_fn(p, ctx.gamma_o, ctx.gamma_t)
                  + _sample_trimmed_logistic(u3, ctx.s, -math.pi, math.pi))
        else:
            dp = 2.0 * math.pi * u3
        sel = p_idx == p
        sin_ti = torch.where(sel, sti, sin_ti)
        cos_ti = torch.where(sel, cti, cos_ti)
        dphi = torch.where(sel, dp, dphi)

    phi_i = ctx.phi_o + dphi
    return torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                        cos_ti * torch.sin(phi_i)], -1)
