"""Analytic quadric intersection — one unified, branch-free test for the
whole pbrt quadric family (counterparts: src/shapes/{sphere,cylinder,disk,
cone,paraboloid,hyperboloid}.cpp).

Instead of per-shape virtual Intersect methods, every quadric is one row of
(kind, radius, zmin, zmax, phimax, q1, q2) packed next to its w2o transform;
a single elementwise routine computes the quadratic coefficients for ALL
kinds with selects and solves once. `quadric_test_parts` is the plain
version of the quadric branch of the CUDA traversal kernel
(csrc/traverse_wide.cu), which repeats it operation for operation.

Kind-specific parameters (object space, pbrt conventions):
  KIND_SPHERE      x^2+y^2+z^2 = r^2          (zmin/zmax/phimax clips)
  KIND_CYLINDER    x^2+y^2 = r^2              (cylinder.cpp:47)
  KIND_DISK        plane z = zmin(=height), innerradius q1 <= dist <= r
                                              (disk.cpp:47)
  KIND_CONE        x^2+y^2 = (r (1 - z/h))^2, h = zmax (cone.cpp:49)
  KIND_PARABOLOID  k (x^2+y^2) = z, k = q1 = zmax_param / r^2
                                              (paraboloid.cpp:50)
  KIND_HYPERBOLOID q1 (x^2+y^2) - q2 z^2 = 1  (hyperboloid.cpp:88; u/v are
                   the cylindrical simplification of the reference's
                   lerped-frame parameterization)
"""

from __future__ import annotations

import math

import numpy as np
import torch

(KIND_SPHERE, KIND_CYLINDER, KIND_DISK, KIND_CONE, KIND_PARABOLOID,
 KIND_HYPERBOLOID) = range(6)

TWO_PI = 6.283185307179586
_EPS_T = 1e-4


def _coeffs(kind, r, zmin, zmax, q1, q2, ox, oy, oz, dx, dy, dz):
    """Quadratic a t^2 + b t + c = 0 per kind (disk handled linearly by the
    caller). All operands elementwise arrays of identical shape."""
    dxy2 = dx * dx + dy * dy
    oxy_dxy = ox * dx + oy * dy
    oxy2 = ox * ox + oy * oy
    is_s = kind == KIND_SPHERE
    is_cy = kind == KIND_CYLINDER
    is_co = kind == KIND_CONE
    is_pa = kind == KIND_PARABOLOID
    is_hy = kind == KIND_HYPERBOLOID
    # cone k = (r/h)^2 with apex at z = h
    h = zmax
    kc = (r / torch.where(h != 0, h, 1.0)) ** 2
    zh = oz - h
    a = torch.where(is_s, dxy2 + dz * dz,
        torch.where(is_cy, dxy2,
        torch.where(is_co, dxy2 - kc * dz * dz,
        torch.where(is_pa, q1 * dxy2,
        torch.where(is_hy, q1 * dxy2 - q2 * dz * dz, 1.0)))))
    b = torch.where(is_s, 2.0 * (oxy_dxy + oz * dz),
        torch.where(is_cy, 2.0 * oxy_dxy,
        torch.where(is_co, 2.0 * (oxy_dxy - kc * dz * zh),
        torch.where(is_pa, 2.0 * q1 * oxy_dxy - dz,
        torch.where(is_hy, 2.0 * (q1 * oxy_dxy - q2 * oz * dz), 0.0)))))
    c = torch.where(is_s, oxy2 + oz * oz - r * r,
        torch.where(is_cy, oxy2 - r * r,
        torch.where(is_co, oxy2 - kc * zh * zh,
        torch.where(is_pa, q1 * oxy2 - oz,
        torch.where(is_hy, q1 * oxy2 - q2 * oz * oz - 1.0, 0.0)))))
    return a, b, c


def quadric_test_parts(kind, r, zmin, zmax, phimax, q1, q2,
                       sin_pm, cos_pm,
                       ox, oy, oz, dx, dy, dz, t_cur):
    """Elementwise closest-valid-root test in OBJECT space. Returns
    (hit, t). Written in pure component form (no stacking, no fancy
    indexing, no transcendentals — the phi <= phimax clip is a half-plane
    wedge test on precomputed sin/cos(phimax)) so the CUDA kernel can
    repeat it line by line."""
    a, b, c = _coeffs(kind, r, zmin, zmax, q1, q2, ox, oy, oz, dx, dy, dz)
    is_disk = kind == KIND_DISK

    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    # numerically stable root pair (same trick as EFloat Quadratic,
    # efloat.h:208: q = -(b + sign(b) sqrt(disc)) / 2)
    qq = -0.5 * (b + torch.where(b < 0.0, -sq, sq))
    a_ok = torch.abs(a) > 1e-12
    q_ok = torch.abs(qq) > 1e-30
    ra = qq / torch.where(a_ok, a, 1.0)
    rc = c / torch.where(q_ok, qq, 1.0)
    ra = torch.where(a_ok, ra, math.inf)
    rc = torch.where(q_ok, rc, math.inf)
    t0 = torch.minimum(ra, rc)
    t1 = torch.maximum(ra, rc)
    # degenerate-to-linear (grazing cone/hyperboloid asymptote): t = -c/b
    b_ok = torch.abs(b) > 1e-20
    tl = -c / torch.where(b_ok, b, 1.0)
    lin = ~a_ok & b_ok
    t0 = torch.where(lin, tl, t0)
    t1 = torch.where(lin, math.inf, t1)
    quad_valid = (disc >= 0.0) & (a_ok | b_ok) & ~is_disk

    # disk: single planar root at z = zmin (== height)
    dz_ok = torch.abs(dz) > 1e-12
    td = (zmin - oz) / torch.where(dz_ok, dz, 1.0)
    t0 = torch.where(is_disk, torch.where(dz_ok, td, math.inf), t0)
    t1 = torch.where(is_disk, math.inf, t1)
    valid = quad_valid | (is_disk & dz_ok)

    def clipped(t):
        finite = torch.isfinite(t)
        ts = torch.where(finite, t, 0.0)
        px = ox + ts * dx
        py = oy + ts * dy
        pz = oz + ts * dz
        ok = finite & (t > _EPS_T) & (t < t_cur)
        # z-interval clip (cone: [zmin(=0), h]; disk replaced by r-annulus)
        ok &= is_disk | ((pz >= zmin) & (pz <= zmax))
        d2 = px * px + py * py
        ok &= ~is_disk | ((d2 <= r * r) & (d2 >= q1 * q1))
        # phi <= phimax as a wedge test: with b = (cos, sin)(phimax),
        # p x b >= 0 keeps points CCW-before the closing edge; for
        # phimax <= pi intersect with the y >= 0 half-plane, for
        # phimax > pi union with it. No atan2 in the hot loop.
        partial = phimax < (TWO_PI - 1e-6)
        ccw = px * sin_pm - py * cos_pm >= 0.0
        upper = py >= 0.0
        le_pi = phimax <= math.pi
        in_wedge = (le_pi & upper & ccw) | (~le_pi & (upper | ccw))
        ok &= ~partial | in_wedge
        return ok

    ok0 = valid & clipped(t0)
    ok1 = valid & ~ok0 & clipped(t1)
    t = torch.where(ok0, t0, t1)
    return ok0 | ok1, torch.where(ok0 | ok1, t, t_cur)


def quadric_test(kind, r, zmin, zmax, phimax, q1, q2, o, d, t_cur):
    """(...,3)-vector wrapper over quadric_test_parts."""
    return quadric_test_parts(
        kind, r, zmin, zmax, phimax, q1, q2,
        torch.sin(phimax), torch.cos(phimax),
        o[..., 0], o[..., 1], o[..., 2],
        d[..., 0], d[..., 1], d[..., 2], t_cur)


def _xform_point(m, p):
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], p) + m[..., :3, 3]


def _xform_vector(m, v):
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], v)


def intersect_quadric(o_w, d_w, tmax, w2o, kind, r, zmin, zmax, phimax,
                      q1, q2):
    """World-space entry: transform the ray, test, return
    (hit, t, p_obj). t stays in world parametric units."""
    o = _xform_point(w2o, o_w)
    d = _xform_vector(w2o, d_w)
    hit, t = quadric_test(kind, r, zmin, zmax, phimax, q1, q2, o, d, tmax)
    p_obj = o + t[..., None] * d
    return hit, t, p_obj


def quadric_normal_uv(p_obj, kind, r, zmin, zmax, phimax, q1, q2):
    """Object-space outward normal and (u, v) at a hit point — the implicit
    gradient replaces per-shape dpdu x dpdv (the world normal goes through
    the inverse transpose as for spheres)."""
    x, y, z = p_obj[..., 0], p_obj[..., 1], p_obj[..., 2]
    is_s = kind == KIND_SPHERE
    is_cy = kind == KIND_CYLINDER
    is_di = kind == KIND_DISK
    is_co = kind == KIND_CONE
    is_pa = kind == KIND_PARABOLOID
    h = zmax
    kc = (r / torch.where(h != 0, h, 1.0)) ** 2
    # gradient components
    nx = torch.where(is_s | is_cy, x,
         torch.where(is_di, 0.0,
         torch.where(is_co, x,
         torch.where(is_pa, 2.0 * q1 * x, 2.0 * q1 * x))))
    ny = torch.where(is_s | is_cy, y,
         torch.where(is_di, 0.0,
         torch.where(is_co, y,
         torch.where(is_pa, 2.0 * q1 * y, 2.0 * q1 * y))))
    nz = torch.where(is_s, z,
         torch.where(is_cy, 0.0,
         torch.where(is_di, 1.0,
         torch.where(is_co, -kc * (z - h),
         torch.where(is_pa, -1.0, -2.0 * q2 * z)))))
    n = torch.stack([nx, ny, nz], -1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-20)

    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    u = phi / phimax.clamp_min(1e-8)
    # v per kind
    zr = (z / torch.where(r != 0, r, 1.0)).clamp(-1.0, 1.0)
    theta = torch.acos(zr)
    th_min = torch.acos((zmax / torch.where(r != 0, r, 1.0)).clamp(-1., 1.))
    th_max = torch.acos((zmin / torch.where(r != 0, r, 1.0)).clamp(-1., 1.))
    v_s = (theta - th_min) / (th_max - th_min).clamp_min(1e-8)
    v_lin = (z - zmin) / (zmax - zmin).clamp_min(1e-8)
    dist = torch.sqrt((x * x + y * y).clamp_min(0.0))
    v_di = (r - dist) / (r - q1).clamp_min(1e-8)  # disk.cpp:90
    v_co = z / torch.where(h != 0, h, 1.0)           # cone.cpp:92
    v = torch.where(is_s, v_s,
        torch.where(is_di, v_di,
        torch.where(is_co, v_co, v_lin)))
    return n, u, v


def quadric_object_bounds(kind, r, zmin, zmax, q1, q2):
    """Numpy per-row object-space AABB (Shape::ObjectBound parity).
    Arrays in, (lo, hi) out."""
    kind = np.asarray(kind)
    r = np.asarray(r, np.float64)
    zmin = np.asarray(zmin, np.float64)
    zmax = np.asarray(zmax, np.float64)
    lo = np.stack([-r, -r, zmin], -1)
    hi = np.stack([r, r, zmax], -1)
    # sphere zmin/zmax already clamped to +-r by the flattener; cone spans
    # [0, h]; disk is flat at z = zmin = zmax = height. Nothing extra to do:
    # the generic box above covers every kind given the stored fields.
    return lo, hi
