"""Normal transform for analytic quadrics (counterpart of the JAX package's
shapes/sphere.py; the intersection itself is shapes/quadric.py)."""

from __future__ import annotations

import torch


def transform_normal(w2o, n_obj):
    """Normals transform by the inverse-transpose: n_w = (w2o)^T n_obj.
    w2o is (..., 3, 3+) — only the upper-left 3x3 is read."""
    n = torch.einsum("...ji,...j->...i", w2o[..., :3, :3], n_obj)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-20)
