"""Monte-Carlo warps (counterpart of src/core/sampling.{h,cpp}): uniform
[0,1)^2 samples to directions and areas."""

from __future__ import annotations

import math

import torch

INV_PI = 1.0 / math.pi
PI_OVER_2 = math.pi / 2.0
PI_OVER_4 = math.pi / 4.0


def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
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
