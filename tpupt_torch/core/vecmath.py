"""Vector/geometry math over SoA tensors whose trailing axis is xyz
(counterpart of the reference's `src/core/geometry.h`). Every function is
out-of-place, so autograd can be switched on over the shading chain."""

from __future__ import annotations

import torch

# Conservative ray-offset epsilon used when spawning secondary rays. The
# reference derives per-hit error bounds with EFloat (core/efloat.h:48) and
# offsets along the normal (interaction.h SpawnRay); in float32 a
# scale-relative epsilon tuned against the golden scenes stands in.
SHADOW_EPS = 1e-3


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length_sq(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_sq(v))


def normalize(v):
    return v * torch.rsqrt(length_sq(v).clamp_min(1e-30))[..., None]


def safe_sqrt(x):
    """sqrt(max(x, 0)) that stays finite in REVERSE mode at x <= 0: the
    double `where` keeps the sqrt input strictly positive, so its partial is
    finite and a masked-out lane's zero cotangent stays zero."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def face_forward(n, v):
    """Flip n into the hemisphere of v (geometry.h Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Orthonormal basis around unit v1 (geometry.h CoordinateSystem),
    branch-free (Duff et al.)."""
    sign = torch.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack(
        [1.0 + sign * v1[..., 0] * v1[..., 0] * a, sign * b, -sign * v1[..., 0]],
        dim=-1,
    )
    v3 = torch.stack([b, sign + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]], dim=-1)
    return v2, v3


def offset_ray_origin(p, n, d):
    """Offset p along n to avoid self-intersection of spawned rays
    (scale-relative stand-in for interaction.h OffsetRayOrigin)."""
    scale = torch.amax(torch.abs(p), dim=-1).clamp_min(1.0)
    off = (SHADOW_EPS * scale)[..., None] * face_forward(n, d)
    return p + off


def ray_inv_d(d):
    """1/d with the slab test's guard for axis-parallel rays: a component
    below 1e-30 gets a huge FINITE reciprocal (1e30 for 0, 2e30 / 0 for
    tiny positive / negative), so (lo - o) * inv_d is never inf * 0 when the
    origin lies on a box face. The traversal kernel keeps the same guard."""
    return torch.where(torch.abs(d) < 1e-30, torch.sign(d) * 1e30 + 1e30,
                       1.0 / d)
