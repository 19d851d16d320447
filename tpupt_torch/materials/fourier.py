"""Tabulated Fourier BSDF — counterpart of materials/fourier.cpp +
FourierBSDF (core/reflection.cpp:307-362).

Reads (and, for test scenes, writes) the binary `.bsdf` format ("SCATFUN"
v1: mu knots, a marginal cdf, per-(muI, muO) Fourier coefficient runs) and
evaluates the azimuthal cosine series with Catmull-Rom interpolation over
the 4x4 neighbouring knot pairs. The 16 pairs and the series' orders k are
evaluated side by side, as one (N, 16, m_max) tensor a channel, with a
length mask in place of the reference's variable-length runs; cos(k phi)
comes from the Chebyshev recurrence, as in the JAX package. The sums run in
another order than there, so values agree to float32 rounding."""

from __future__ import annotations

import math
import struct
import warnings

import numpy as np
import torch

_MAGIC = b"SCATFUN\x01"


def read_bsdf_file(path: str):
    """FourierBSDFTable::Read parity (fourier.cpp:106-200): a dict of numpy
    arrays (mu, a, cdf, aoffset, m) and ints (m_max, n_mu, n_channels) and
    eta, or None (with a warning) for a file that is not SCATFUN v1 with one
    basis and 1 or 3 channels."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _MAGIC:
        warnings.warn(f"{path}: not a SCATFUN v1 .bsdf file")
        return None
    (flags, n_mu, n_coeffs, m_max, n_channels, n_bases, _, _, _
     ) = struct.unpack_from("<9i", data, 8)
    (eta,) = struct.unpack_from("<f", data, 8 + 36)
    off = 8 + 36 + 4 + 16  # header + ints + eta + 4 unused ints
    if flags != 1 or n_channels not in (1, 3) or n_bases != 1:
        warnings.warn(f"{path}: unsupported .bsdf variant")
        return None
    mu = np.frombuffer(data, "<f4", n_mu, off)
    off += 4 * n_mu
    # marginal cdf over muI per muO row, the importance sampler's table
    cdf = np.frombuffer(data, "<f4", n_mu * n_mu, off)
    off += 4 * n_mu * n_mu
    oal = np.frombuffer(data, "<i4", 2 * n_mu * n_mu, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    a = np.frombuffer(data, "<f4", n_coeffs, off)
    return dict(mu=mu.astype(np.float32), a=a.astype(np.float32),
                cdf=cdf.astype(np.float32),
                aoffset=oal[:, 0].astype(np.int32),
                m=oal[:, 1].astype(np.int32), m_max=int(m_max),
                n_mu=int(n_mu), n_channels=int(n_channels), eta=float(eta))


def write_bsdf_file(path: str, tbl: dict):
    """Write `tbl` (the dict `read_bsdf_file` returns) as a SCATFUN v1
    file that `read_bsdf_file` reads back unchanged."""
    n_mu = int(tbl["n_mu"])
    a = np.asarray(tbl["a"], "<f4")
    head = struct.pack("<9i", 1, n_mu, len(a), int(tbl["m_max"]),
                       int(tbl["n_channels"]), 1, 0, 0, 0)
    oal = np.stack([np.asarray(tbl["aoffset"], "<i4"),
                    np.asarray(tbl["m"], "<i4")], -1)
    with open(path, "wb") as f:
        f.write(_MAGIC + head + struct.pack("<f", float(tbl["eta"]))
                + bytes(16))
        f.write(np.asarray(tbl["mu"], "<f4").tobytes())
        f.write(np.asarray(tbl["cdf"], "<f4").tobytes())
        f.write(oal.tobytes())
        f.write(a.tobytes())


def catmullrom_weights(knots, x):
    """Batched CatmullRomWeights (core/interpolation.cpp:180-230):
    (offset, w, ok), w (N,4) spline weights over knots[offset..offset+3]
    (offset may be -1 or reach past the end, where the weight is 0)."""
    n = knots.shape[0]
    i = (torch.searchsorted(knots, x.contiguous(), right=True) - 1).clamp(
        0, n - 2)
    x0 = knots[i]
    x1 = knots[i + 1]
    t = ((x - x0) / (x1 - x0).clamp_min(1e-12)).clamp(0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2 * t3 - 3 * t2 + 1
    w2 = -2 * t3 + 3 * t2
    have_prev = i > 0
    w0p = (t3 - 2 * t2 + t) * (x1 - x0) / (
        x1 - knots[(i - 1).clamp_min(0)]).clamp_min(1e-12)
    w0f = t3 - 2 * t2 + t
    w0_ = torch.where(have_prev, -w0p, 0.0)
    w1 = w1 - torch.where(have_prev, 0.0, w0f)
    w2 = w2 + torch.where(have_prev, w0p, w0f)
    have_next = i + 2 < n
    w3n = (t3 - t2) * (x1 - x0) / (
        knots[(i + 2).clamp_max(n - 1)] - x0).clamp_min(1e-12)
    w3f = t3 - t2
    w1 = w1 - torch.where(have_next, w3n, w3f)
    w2 = w2 + torch.where(have_next, 0.0, w3f)
    w3_ = torch.where(have_next, w3n, 0.0)
    w = torch.stack([w0_, w1, w2, w3_], -1)
    ok = (x >= knots[0]) & (x <= knots[-1])
    return i - 1, w, ok


def fourier_f(tbl, wo, wi):
    """FourierBSDF::f batched. tbl: dict of tensors + static ints (the
    tables of DeviceScene's four_* fields and SceneStatics.fourier).
    Convention matches the reference: muI = cos(-wi), muO = cos(wo)."""
    mu, n_mu, m_max = tbl["mu"], tbl["n_mu"], tbl["m_max"]
    n_ch = tbl["n_channels"]
    a, m_arr, aoff = tbl["a"], tbl["m"], tbl["aoffset"]

    mu_i = -wi[..., 2]
    mu_o = wo[..., 2]
    # cos of the azimuth difference between -wi and wo (CosDPhi)
    ax, ay = -wi[..., 0], -wi[..., 1]
    bx, by = wo[..., 0], wo[..., 1]
    den = torch.sqrt(((ax * ax + ay * ay) * (bx * bx + by * by))
                     .clamp_min(1e-20))
    cos_phi = ((ax * bx + ay * by) / den).clamp(-1.0, 1.0)

    oi, wi4, ok_i = catmullrom_weights(mu, mu_i)
    oo, wo4, ok_o = catmullrom_weights(mu, mu_o)
    valid = ok_i & ok_o

    # the 16 knot pairs side by side, (N, 16) in the reference's order
    # (muO offset b major, muI offset a minor)
    ar4 = torch.arange(4, device=wo.device)
    ii = (oi[:, None, None] + ar4[None, None, :]).clamp(0, n_mu - 1)
    jj = (oo[:, None, None] + ar4[None, :, None]).clamp(0, n_mu - 1)
    pair = (jj * n_mu + ii).reshape(-1, 16).long()
    w = (wi4[:, None, :] * wo4[:, :, None]).reshape(-1, 16)
    off = aoff[pair].long()[..., None]
    m = m_arr[pair].long()[..., None]
    # cos(k phi), k < m_max, by the Chebyshev recurrence: (N, 1, m_max)
    cks = [torch.ones_like(cos_phi), cos_phi]
    for _ in range(2, m_max):
        cks.append(2.0 * cos_phi * cks[-1] - cks[-2])
    ck = torch.stack(cks[:m_max], -1)[:, None, :]
    k = torch.arange(m_max, device=wo.device)
    live = k < m                                           # (N, 16, m_max)
    wck = w[..., None] * ck
    out = []
    for c in range(n_ch):
        coef = a[(off + c * m + k).clamp(0, a.shape[0] - 1)]
        out.append(torch.where(live, wck * coef, 0.0).sum((-1, -2)))

    scale = torch.where(torch.abs(mu_i) > 1e-6,
                        1.0 / torch.abs(mu_i).clamp_min(1e-6), 0.0)
    y = out[0].clamp_min(0.0)
    if n_ch == 1:
        rgb = torch.stack([y, y, y], -1)
    else:
        r, b_ = out[1], out[2]
        g = 1.39829 * y - 0.100913 * b_ - 0.297375 * r
        rgb = torch.stack([r, g, b_], -1).clamp_min(0.0)
    return torch.where(valid[..., None], rgb * scale[..., None], 0.0)


def _cdf_row(tbl, mu_o):
    """Catmull-Rom-weighted combination of the 4 cdf rows around mu_o:
    R (N, n_mu) is the conditional (unnormalized) cdf over muI given muO
    (the linear-inversion analog of SampleCatmullRom2D's row blend,
    interpolation.cpp:290), made monotone by a running max."""
    mu, n_mu, cdf = tbl["mu"], tbl["n_mu"], tbl["cdf"]
    oo, wo4, ok_o = catmullrom_weights(mu, mu_o)
    cols = torch.arange(n_mu, device=mu_o.device)
    R = 0.0
    for b in range(4):
        jj = (oo + b).clamp(0, n_mu - 1)
        R = R + wo4[..., b:b + 1] * cdf[(jj[..., None] * n_mu
                                         + cols[None, :]).long()]
    R = torch.cummax(R.clamp_min(0.0), dim=-1).values
    return R, ok_o


def fourier_pdf(tbl, wo, wi):
    """Solid-angle pdf of fourier_sample: piecewise-constant-in-mu
    conditional density from the tabulated cdf, uniform in azimuth
    (FourierBSDF::Pdf up to the linear-vs-spline inversion,
    reflection.cpp:573)."""
    mu, n_mu = tbl["mu"], tbl["n_mu"]
    mu_i = -wi[..., 2]
    R, ok_o = _cdf_row(tbl, wo[..., 2])
    i = (torch.searchsorted(mu, mu_i.contiguous(), right=True) - 1).clamp(
        0, n_mu - 2)
    c_lo = R.gather(-1, i[..., None])[..., 0]
    c_hi = R.gather(-1, (i + 1)[..., None])[..., 0]
    norm = R[..., n_mu - 1]
    seg = (mu[i + 1] - mu[i]).clamp_min(1e-12)
    pdf_mu = torch.where(norm > 1e-12,
                         (c_hi - c_lo) / (seg * norm.clamp_min(1e-12)), 0.0)
    ok = ok_o & (mu_i >= mu[0]) & (mu_i <= mu[-1])
    return torch.where(ok, pdf_mu.clamp_min(0.0) / (2.0 * math.pi), 0.0)


def fourier_sample(tbl, wo, u1, u2):
    """Sample wi from the tabulated distribution: invert the conditional
    muI cdf (piecewise linear), pick the azimuth offset uniformly. Returns
    wi (N,3); its pdf is fourier_pdf(tbl, wo, wi)."""
    mu, n_mu = tbl["mu"], tbl["n_mu"]
    R, _ = _cdf_row(tbl, wo[..., 2])
    norm = R[..., n_mu - 1]
    target = u1 * norm
    i = (torch.sum(R <= target[..., None], -1) - 1).clamp(0, n_mu - 2)
    c_lo = R.gather(-1, i[..., None])[..., 0]
    c_hi = R.gather(-1, (i + 1)[..., None])[..., 0]
    t = ((target - c_lo) / (c_hi - c_lo).clamp_min(1e-12)).clamp(0.0, 1.0)
    mu_i = (mu[i] + t * (mu[i + 1] - mu[i])).clamp(-1.0, 1.0)
    # azimuth: -wi gets wo's azimuth plus a uniform offset
    phi = torch.atan2(wo[..., 1], wo[..., 0]) + 2.0 * math.pi * u2
    sin_i = torch.sqrt((1.0 - mu_i * mu_i).clamp_min(1e-20))
    # -wi = (sin_i cos(phi), sin_i sin(phi), mu_i)
    return -torch.stack([sin_i * torch.cos(phi), sin_i * torch.sin(phi),
                         mu_i], -1)
