"""Camera ray generation (counterpart of src/cameras/{perspective,
orthographic,environment}.cpp GenerateRay).

Batched: takes film-plane sample positions (N,2) in raster space plus lens
samples, returns world-space rays. Thin-lens depth of field matches
perspective.cpp:69-117. An animated camera (two keys of its camera-to-world
transform) is slerped per ray at the ray's shutter time; the realistic lens
camera has its own ray generator, cameras/realistic.py `realistic_rays`."""

from __future__ import annotations

import math

import torch

from tpupt_torch.core.sampling import concentric_sample_disk
from tpupt_torch.core.vecmath import normalize
from tpupt_torch.scene.flatten import CAM_ENVIRONMENT, CAM_ORTHOGRAPHIC


def _xform_point(m, p):
    r = torch.einsum("ij,...j->...i", m[:3, :3], p) + m[:3, 3]
    w = torch.einsum("j,...j->...", m[3, :3], p) + m[3, 3]
    return r / w[..., None]


def _xform_vector(m, v):
    return torch.einsum("ij,...j->...i", m[:3, :3], v)


def _quat_slerp_batch(q0, q1, t):
    """Per-ray quaternion slerp (AnimatedTransform::Interpolate,
    transform.cpp:1144, batched): q0 / q1 (4,), t (N,) -> (N,4)."""
    cos_th = torch.sum(q0 * q1)
    lin = (1.0 - t)[:, None] * q0[None] + t[:, None] * q1[None]
    lin = lin / torch.linalg.norm(lin, dim=-1, keepdim=True).clamp_min(1e-12)
    theta = torch.arccos(cos_th.clamp(-1.0, 1.0))
    qperp = q1 - q0 * cos_th
    qperp = qperp / torch.linalg.norm(qperp).clamp_min(1e-12)
    sl = (torch.cos(theta * t)[:, None] * q0[None]
          + torch.sin(theta * t)[:, None] * qperp[None])
    return torch.where(cos_th > 0.9995, lin, sl)


def _quat_rotate(q, v):
    """Rotate vectors v (N,3) by unit quaternions q (N,4) [w,x,y,z]
    (core/transforms.py convention)."""
    u = q[:, 1:4]
    w = q[:, 0:1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def generate_rays(cam_type: int, raster_to_camera, cam_to_world,
                  p_raster, u_lens, lens_radius: float, focal_distance: float,
                  xres: int = 0, yres: int = 0, cam_q=None, cam_tr=None,
                  time=None):
    """p_raster: (N,2) film positions; u_lens: (N,2) in [0,1)^2; xres / yres
    the film size (the environment camera maps it onto the sphere).
    Returns (o_world, d_world).

    cam_q (2,4) / cam_tr (2,3) with time (N,): the animated camera's keys;
    the camera-to-world rigid transform is slerped per ray at its shutter
    time (AnimatedTransform::InterpolateRay; scale keys are not taken)."""
    n = p_raster.shape[0]
    zeros1 = p_raster.new_zeros((n, 1))
    if cam_type == CAM_ENVIRONMENT:
        # equirectangular (cameras/environment.cpp:46)
        theta = math.pi * p_raster[:, 1] / yres
        phi = 2 * math.pi * p_raster[:, 0] / xres
        d_cam = torch.stack(
            [torch.sin(theta) * torch.cos(phi), torch.cos(theta),
             torch.sin(theta) * torch.sin(phi)], -1)
        o_cam = p_raster.new_zeros((n, 3))
    else:
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
    if cam_q is not None and time is not None:
        q = _quat_slerp_batch(cam_q[0], cam_q[1], time)
        tr = (1.0 - time)[:, None] * cam_tr[0][None] \
            + time[:, None] * cam_tr[1][None]
        o_w = _quat_rotate(q, o_cam) + tr
        d_w = normalize(_quat_rotate(q, d_cam))
        return o_w, d_w
    o_w = _xform_point(cam_to_world, o_cam)
    d_w = normalize(_xform_vector(cam_to_world, d_cam))
    return o_w, d_w
