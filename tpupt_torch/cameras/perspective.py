"""Camera ray generation (counterpart of src/cameras/{perspective,
orthographic}.cpp GenerateRay).

Batched: takes film-plane sample positions (N,2) in raster space plus lens
samples, returns world-space rays. Thin-lens depth of field matches
perspective.cpp:69-117. The environment and animated cameras are not ported
yet and raise."""

from __future__ import annotations

import torch

from tpupt_torch.core.sampling import concentric_sample_disk
from tpupt_torch.core.vecmath import normalize
from tpupt_torch.scene.flatten import CAM_ORTHOGRAPHIC, CAM_PERSPECTIVE


def _xform_point(m, p):
    r = torch.einsum("ij,...j->...i", m[:3, :3], p) + m[:3, 3]
    w = torch.einsum("j,...j->...", m[3, :3], p) + m[3, 3]
    return r / w[..., None]


def _xform_vector(m, v):
    return torch.einsum("ij,...j->...i", m[:3, :3], v)


def generate_rays(cam_type: int, raster_to_camera, cam_to_world,
                  p_raster, u_lens, lens_radius: float, focal_distance: float):
    """p_raster: (N,2) film positions; u_lens: (N,2) in [0,1)^2.
    Returns (o_world, d_world)."""
    if cam_type not in (CAM_PERSPECTIVE, CAM_ORTHOGRAPHIC):
        raise NotImplementedError(
            "only the perspective and orthographic cameras are in the "
            "PyTorch port (ROADMAP.md queue 1, items 3 and 10)")
    n = p_raster.shape[0]
    zeros1 = p_raster.new_zeros((n, 1))
    p_film = torch.cat([p_raster, zeros1], dim=-1)
    p_cam = _xform_point(raster_to_camera, p_film)
    if cam_type == CAM_ORTHOGRAPHIC:
        o_cam = p_cam
        d_cam = p_raster.new_tensor([0.0, 0.0, 1.0]).expand(n, 3)
    else:
        o_cam = p_raster.new_zeros((n, 3))
        d_cam = normalize(p_cam)
    if lens_radius > 0.0:
        lx, ly = concentric_sample_disk(u_lens[:, 0], u_lens[:, 1])
        p_lens = lens_radius * torch.stack([lx, ly], dim=-1)
        ft = focal_distance / d_cam[:, 2].clamp_min(1e-6)
        p_focus = o_cam + ft[:, None] * d_cam
        o_cam = torch.cat([p_lens, zeros1], dim=-1)
        d_cam = normalize(p_focus - o_cam)
    o_w = _xform_point(cam_to_world, o_cam)
    d_w = normalize(_xform_vector(cam_to_world, d_cam))
    return o_w, d_w
