"""Monte-Carlo warps and sampling distributions (counterpart of
src/core/sampling.{h,cpp}): uniform [0,1)^2 samples to directions and
areas; piecewise-constant 1D / 2D distributions, built on the host and
sampled on the device."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INV_PI = 1.0 / math.pi
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_hemisphere(u1, u2):
    z = u1
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric disk warp (sampling.cpp ConcentricSampleDisk),
    branch-free."""
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        PI_OVER_4 * (oy / torch.where(ox == 0.0, 1.0, ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / torch.where(oy == 0.0, 1.0, oy)),
    )
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return x, y


def cosine_sample_hemisphere(u1, u2):
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt((1.0 - dx * dx - dy * dy).clamp_min(0.0))
    return torch.stack([dx, dy, z], dim=-1)


def uniform_sample_triangle(u1, u2):
    su0 = torch.sqrt(u1)
    return 1.0 - su0, u2 * su0


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * (1.0 - cos_theta_max))


def uniform_sample_cone(u1, u2, cos_theta_max):
    cos_t = (1.0 - u1) + u1 * cos_theta_max
    # floor the sqrt arg: d/dx sqrt(x) at exactly 0 is inf, which poisons
    # reverse mode through where-masked branches (0 * inf = NaN)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(1e-20))
    phi = u2 * 2.0 * math.pi
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t],
                       dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """MIS power heuristic beta=2 (sampling.h PowerHeuristic)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    ok = denom > 0.0
    return torch.where(ok, f * f / torch.where(ok, denom, 1.0), 0.0)


# --------------------------- distributions ---------------------------------


def build_distribution1d(func: np.ndarray):
    """Host build of piecewise-constant 1D distributions (sampling.h:58
    Distribution1D), batched over leading axes: (func, cdf, integral) as
    float32 numpy arrays, func (..., N), cdf (..., N+1) = [0, cumsum(func)
    / N] / integral, and a uniform cdf where the integral is 0
    (sampling.cpp:72)."""
    func = np.asarray(func, np.float32)
    n = func.shape[-1]
    cdf = np.concatenate(
        [np.zeros(func.shape[:-1] + (1,), np.float32),
         np.cumsum(func, -1, dtype=np.float32) / np.float32(n)], -1)
    integral = cdf[..., -1].copy()
    uniform = np.arange(n + 1, dtype=np.float32) / np.float32(n)
    safe = integral[..., None] > 0.0
    cdf = np.where(safe, cdf / np.where(safe, integral[..., None], 1.0),
                   uniform).astype(np.float32)
    return func, cdf, integral


def build_distribution2d(func: np.ndarray):
    """Host build of a 2D distribution (sampling.h:190 Distribution2D): one
    conditional distribution a row and the marginal over the rows'
    integrals. Returns (cond_func (H,W), cond_cdf (H,W+1), cond_integral
    (H,), marg_func (H,), marg_cdf (H+1,), marg_integral ())."""
    cond = build_distribution1d(func)
    marg = build_distribution1d(cond[2])
    return cond + marg


def _last_le(cdf, u):
    """Index of the last entry of the sorted `cdf` that is <= u, clamped to
    [0, len - 2]: searchsorted(side="right") - 1."""
    n = cdf.shape[-1] - 1
    return (torch.searchsorted(cdf, u.contiguous(), right=True) - 1).clamp(
        0, n - 1)


class Distribution1D(NamedTuple):
    """Piecewise-constant 1D distribution on the device: func (N,), cdf
    (N+1,), integral () from `build_distribution1d`."""

    func: torch.Tensor
    cdf: torch.Tensor
    integral: torch.Tensor

    @property
    def count(self) -> int:
        return self.func.shape[-1]

    def sample_continuous(self, u):
        """(x in [0,1), pdf, offset)."""
        n = self.count
        off = _last_le(self.cdf, u)
        c0, c1 = self.cdf[off], self.cdf[off + 1]
        ok = c1 > c0
        du = torch.where(ok, (u - c0) / torch.where(ok, c1 - c0, 1.0), 0.0)
        pdf = torch.where(self.integral > 0.0,
                          self.func[off] / self.integral.clamp_min(1e-30), 0.0)
        return (off.to(torch.float32) + du) / n, pdf, off

    def sample_discrete(self, u):
        """(offset, pmf)."""
        off = _last_le(self.cdf, u)
        return off, self.discrete_pdf(off)

    def discrete_pdf(self, index):
        return torch.where(
            self.integral > 0.0,
            self.func[index] / (self.integral * self.count).clamp_min(1e-30),
            1.0 / self.count)


class Distribution2D(NamedTuple):
    """2D distribution on the device from `build_distribution2d`'s tables.

    The row search does not gather each lane's conditional cdf row (that
    is (N, W+1) floats, a gigabyte at a 2048-wide map and 131,072 lanes):
    the cdf entries, non-negative float32, keep their order as int32 bit
    patterns, so row r's key row * 2^32 + bits(cdf) orders the flattened
    table as a whole, and one searchsorted of row * 2^32 + bits(u) over it
    counts, exactly, the entries of row r that are <= u, repeated values
    included."""

    cond_func: torch.Tensor
    cond_cdf: torch.Tensor
    cond_integral: torch.Tensor
    marg_func: torch.Tensor
    marg_cdf: torch.Tensor
    marg_integral: torch.Tensor

    def sample_continuous(self, u1, u2):
        """((u, v), pdf)."""
        marg = Distribution1D(self.marg_func, self.marg_cdf,
                              self.marg_integral)
        v, pdf_v, row = marg.sample_continuous(u2)
        h, w = self.cond_func.shape
        base = row.to(torch.int64) * (w + 1)
        keys = (self.cond_cdf.view(torch.int32).to(torch.int64)
                + (torch.arange(h, device=u1.device, dtype=torch.int64)
                   << 32)[:, None]).reshape(-1)
        query = (u1.contiguous().view(torch.int32).to(torch.int64)
                 + (row.to(torch.int64) << 32))
        off = (torch.searchsorted(keys, query, right=True) - base - 1).clamp(
            0, w - 1)
        flat_cdf = self.cond_cdf.reshape(-1)
        c0 = flat_cdf[base + off]
        c1 = flat_cdf[base + off + 1]
        ok = c1 > c0
        du = torch.where(ok, (u1 - c0) / torch.where(ok, c1 - c0, 1.0), 0.0)
        f = self.cond_func.reshape(-1)[row.to(torch.int64) * w + off]
        integ = self.cond_integral[row]
        pdf_u = torch.where(integ > 0.0, f / integ.clamp_min(1e-30), 0.0)
        uu = (off.to(torch.float32) + du) / w
        return (uu, v), pdf_u * pdf_v

    def pdf(self, u, v):
        h, w = self.cond_func.shape
        iu = (u * w).to(torch.int64).clamp(0, w - 1)
        iv = (v * h).to(torch.int64).clamp(0, h - 1)
        return (self.cond_func.reshape(-1)[iv * w + iu]
                / self.marg_integral.clamp_min(1e-30))
