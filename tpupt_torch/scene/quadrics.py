"""Quadric shapes as parametric tessellations (src/shapes/{cylinder,disk,cone,
paraboloid,hyperboloid}.cpp counterparts).

Spheres are intersected analytically on device (shapes/sphere.py); the other
quadrics are tessellated here at flatten time into triangle meshes with exact
parametric normals — here a dense triangle soup through the one batched
intersector beats per-type analytic branches."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _grid_faces(nu: int, nv: int) -> np.ndarray:
    """Triangulate an (nu+1)x(nv+1) vertex grid."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    v00 = (i * (nv + 1) + j).ravel()
    v10 = ((i + 1) * (nv + 1) + j).ravel()
    v01 = (i * (nv + 1) + j + 1).ravel()
    v11 = ((i + 1) * (nv + 1) + j + 1).ravel()
    return np.concatenate(
        [np.stack([v00, v10, v11], -1), np.stack([v00, v11, v01], -1)]
    ).astype(np.int32)


def _param_mesh(fp, fn, u0, u1, v0, v1, nu, nv) -> Tuple[np.ndarray, ...]:
    u = np.linspace(u0, u1, nu + 1)
    v = np.linspace(v0, v1, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    P = fp(uu.ravel(), vv.ravel())
    N = fn(uu.ravel(), vv.ravel())
    uvs = np.stack([(uu.ravel() - u0) / max(u1 - u0, 1e-12),
                    (vv.ravel() - v0) / max(v1 - v0, 1e-12)], -1)
    return P, N, uvs, _grid_faces(nu, nv)


def tessellate_cylinder(radius, zmin, zmax, phimax_deg, nu=64, nv=8):
    phimax = np.deg2rad(phimax_deg)

    def fp(u, v):
        phi = u * phimax
        return np.stack([radius * np.cos(phi), radius * np.sin(phi),
                         zmin + v * (zmax - zmin)], -1)

    def fn(u, v):
        phi = u * phimax
        return np.stack([np.cos(phi), np.sin(phi), np.zeros_like(u)], -1)

    return _param_mesh(fp, fn, 0, 1, 0, 1, nu, nv)


def tessellate_disk(height, radius, inner_radius, phimax_deg, nu=64, nv=4):
    phimax = np.deg2rad(phimax_deg)

    def fp(u, v):
        phi = u * phimax
        r = radius + v * (inner_radius - radius)
        return np.stack([r * np.cos(phi), r * np.sin(phi),
                         np.full_like(u, height)], -1)

    def fn(u, v):
        return np.stack([np.zeros_like(u), np.zeros_like(u), np.ones_like(u)], -1)

    return _param_mesh(fp, fn, 0, 1, 0, 1, nu, nv)


def tessellate_cone(height, radius, phimax_deg, nu=64, nv=16):
    phimax = np.deg2rad(phimax_deg)

    def fp(u, v):
        phi = u * phimax
        r = radius * (1.0 - v)
        return np.stack([r * np.cos(phi), r * np.sin(phi), v * height], -1)

    def fn(u, v):
        phi = u * phimax
        # dpdu x dpdv for cone (cone.cpp Intersect normal math)
        n = np.stack([height * np.cos(phi), height * np.sin(phi),
                      np.full_like(u, radius)], -1)
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    return _param_mesh(fp, fn, 0, 1, 0, 1 - 1e-4, nu, nv)


def tessellate_paraboloid(radius, zmin, zmax, phimax_deg, nu=64, nv=16):
    phimax = np.deg2rad(phimax_deg)
    k = zmax / (radius * radius)

    def fp(u, v):
        phi = u * phimax
        z = zmin + v * (zmax - zmin)
        r = np.sqrt(np.maximum(z / k, 0.0))
        return np.stack([r * np.cos(phi), r * np.sin(phi), z], -1)

    def fn(u, v):
        phi = u * phimax
        z = np.maximum(zmin + v * (zmax - zmin), 1e-8)
        r = np.sqrt(z / k)
        # gradient of (x^2+y^2) * k - z
        n = np.stack([2 * k * r * np.cos(phi), 2 * k * r * np.sin(phi),
                      -np.ones_like(u)], -1)
        n = -n
        return n / np.linalg.norm(n, axis=-1, keepdims=True)

    return _param_mesh(fp, fn, 0, 1, max(1e-5, zmin / max(zmax, 1e-9)) * 0, 1, nu, nv)


def tessellate_hyperboloid(p1, p2, phimax_deg, nu=64, nv=16):
    phimax = np.deg2rad(phimax_deg)
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)

    def fp(u, v):
        phi = u * phimax
        pr = (1 - v)[:, None] * p1[None, :] + v[:, None] * p2[None, :]
        x = pr[:, 0] * np.cos(phi) - pr[:, 1] * np.sin(phi)
        y = pr[:, 0] * np.sin(phi) + pr[:, 1] * np.cos(phi)
        return np.stack([x, y, pr[:, 2]], -1)

    def fn(u, v):
        # finite-difference normals (hyperboloid.cpp computes dpdu x dpdv)
        eps = 1e-4
        p0 = fp(u, v)
        pu = fp(u + eps, v)
        pv = fp(u, np.minimum(v + eps, 1.0))
        n = np.cross(pu - p0, pv - p0)
        ln = np.linalg.norm(n, axis=-1, keepdims=True)
        return n / np.where(ln > 0, ln, 1.0)

    return _param_mesh(fp, fn, 0, 1, 0, 1, nu, nv)


def tessellate_heightfield(nx: int, ny: int, z: np.ndarray):
    """Heightfield -> trianglemesh (shapes/heightfield.cpp CreateHeightfield)."""
    x = np.linspace(0, 1, nx)
    y = np.linspace(0, 1, ny)
    xx, yy = np.meshgrid(x, y, indexing="ij")
    P = np.stack([xx.ravel(), yy.ravel(), np.asarray(z, np.float64).reshape(nx, ny).ravel()], -1)
    F = _grid_faces(nx - 1, ny - 1)
    return P, None, np.stack([xx.ravel(), yy.ravel()], -1), F


def _bezier_eval(cp, t):
    """Cubic Bézier point + tangent; cp (4,3), t (K,)."""
    t = t[:, None]
    mt = 1.0 - t
    p = (mt ** 3 * cp[0] + 3 * mt ** 2 * t * cp[1]
         + 3 * mt * t ** 2 * cp[2] + t ** 3 * cp[3])
    d = (3 * mt ** 2 * (cp[1] - cp[0]) + 6 * mt * t * (cp[2] - cp[1])
         + 3 * t ** 2 * (cp[3] - cp[2]))
    return p, d


def _bspline_to_bezier(cp4):
    """Uniform cubic B-spline window (4,3) -> Bézier control points."""
    b0 = (cp4[0] + 4 * cp4[1] + cp4[2]) / 6.0
    b1 = (2 * cp4[1] + cp4[2]) / 3.0
    b2 = (cp4[1] + 2 * cp4[2]) / 3.0
    b3 = (cp4[1] + 4 * cp4[2] + cp4[3]) / 6.0
    return np.stack([b0, b1, b2, b3])


def tessellate_curve(P, width0, width1, curve_type="flat", basis="bezier",
                     degree=3, normals=None, samples_per_seg=12):
    """Curve -> triangle ribbon (shapes/curve.cpp CreateCurveShape parity).

    The reference intersects curves by recursive Bézier splitting against
    each ray (curve.cpp:105-240); the wavefront equivalent tessellates once
    at flatten time into a ribbon whose v coordinate spans the width — which
    is exactly what the hair BSDF needs for its fiber offset h = -1+2v
    (hair.cpp:141). 'flat'/'cylinder' ribbons are oriented by a rotation-
    minimizing frame; 'ribbon' uses the supplied per-endpoint normals."""
    P = np.asarray(P, np.float64).reshape(-1, 3)
    if degree == 2:  # elevate quadratic to cubic
        segs_cp = []
        step = 2 if basis == "bezier" else 1
        for s in range(0, len(P) - 2, step):
            q = P[s:s + 3]
            if len(q) < 3:
                break
            if basis == "bspline":  # uniform quadratic B-spline -> Bézier
                q = np.stack([(q[0] + q[1]) / 2.0, q[1], (q[1] + q[2]) / 2.0])
            segs_cp.append(np.stack([
                q[0], q[0] + 2.0 / 3.0 * (q[1] - q[0]),
                q[2] + 2.0 / 3.0 * (q[1] - q[2]), q[2]]))
    elif basis == "bspline":
        segs_cp = [_bspline_to_bezier(P[s:s + 4])
                   for s in range(len(P) - 3)]
    else:
        segs_cp = [P[s:s + 3 + 1] for s in range(0, len(P) - 3, 3)]
    if not segs_cp:
        return None

    n_seg = len(segs_cp)
    pts, tans = [], []
    for i, cp in enumerate(segs_cp):
        t = np.linspace(0, 1, samples_per_seg + 1)
        if i > 0:
            t = t[1:]  # shared endpoint
        p, d = _bezier_eval(cp, t)
        pts.append(p)
        tans.append(d)
    pts = np.concatenate(pts)
    tans = np.concatenate(tans)
    k = len(pts)
    tl = np.linalg.norm(tans, axis=-1, keepdims=True)
    tans = tans / np.maximum(tl, 1e-12)

    # frame normals: supplied (ribbon) or rotation-minimizing (double
    # reflection, Wang et al. 2008)
    u_param = np.linspace(0, 1, k)
    if curve_type == "ribbon" and normals is not None and len(normals) >= 2:
        n0 = np.asarray(normals, np.float64).reshape(-1, 3)
        # interpolate between per-segment-endpoint normals along the curve
        tt = u_param * (len(n0) - 1)
        i0 = np.minimum(tt.astype(int), len(n0) - 2)
        w = (tt - i0)[:, None]
        nrm = (1 - w) * n0[i0] + w * n0[i0 + 1]
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    else:
        nrm = np.zeros((k, 3))
        ref = np.array([0.0, 0.0, 1.0])
        if abs(np.dot(ref, tans[0])) > 0.9:
            ref = np.array([1.0, 0.0, 0.0])
        nrm[0] = np.cross(tans[0], ref)
        nrm[0] /= max(np.linalg.norm(nrm[0]), 1e-12)
        for i in range(1, k):  # double-reflection RMF
            v1 = pts[i] - pts[i - 1]
            c1 = max(np.dot(v1, v1), 1e-18)
            rl = nrm[i - 1] - (2.0 / c1) * np.dot(v1, nrm[i - 1]) * v1
            tl_ = tans[i - 1] - (2.0 / c1) * np.dot(v1, tans[i - 1]) * v1
            v2 = tans[i] - tl_
            c2 = max(np.dot(v2, v2), 1e-18)
            nrm[i] = rl - (2.0 / c2) * np.dot(v2, rl) * v2
            nl = np.linalg.norm(nrm[i])
            nrm[i] = nrm[i] / nl if nl > 1e-12 else nrm[i - 1]

    widths = (1 - u_param) * width0 + u_param * width1
    # ribbon spans along cross(N, T); surface normal is N
    side = np.cross(nrm, tans)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
    half = 0.5 * widths[:, None] * side
    verts = np.concatenate([pts - half, pts + half])  # v=0 rows then v=1
    vnorm = np.concatenate([nrm, nrm])
    uv = np.concatenate([np.stack([u_param, np.zeros(k)], -1),
                         np.stack([u_param, np.ones(k)], -1)])
    f = []
    for i in range(k - 1):
        a, b = i, i + 1
        c, d = k + i, k + i + 1
        f += [[a, b, d], [a, d, c]]
    return verts, vnorm, uv, np.asarray(f, np.int64)


def _bspline_basis(i, p, u, knots):
    """Cox-de Boor recursion (vectorized over u)."""
    if p == 0:
        last = knots[i + 1] >= knots[-1]
        hi = (u < knots[i + 1]) | (last & (u <= knots[i + 1]))
        return ((u >= knots[i]) & hi).astype(np.float64)
    out = np.zeros_like(u)
    d1 = knots[i + p] - knots[i]
    if d1 > 0:
        out += (u - knots[i]) / d1 * _bspline_basis(i, p - 1, u, knots)
    d2 = knots[i + p + 1] - knots[i + 1]
    if d2 > 0:
        out += (knots[i + p + 1] - u) / d2 * _bspline_basis(i + 1, p - 1, u, knots)
    return out


def tessellate_nurbs(nu, nv, uorder, vorder, uknots, vknots,
                     u0, u1, v0, v1, P, w=None, res_u=32, res_v=32):
    """NURBS surface -> trianglemesh (shapes/nurbs.cpp parity): rational
    B-spline surface evaluated on a grid via Cox-de Boor, normals from
    central differences of the evaluated grid."""
    P = np.asarray(P, np.float64).reshape(nv, nu, 3)
    w = (np.ones((nv, nu)) if w is None
         else np.asarray(w, np.float64).reshape(nv, nu))
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    us = np.linspace(u0, u1, res_u + 1)
    vs = np.linspace(v0, v1, res_v + 1)
    bu = np.stack([_bspline_basis(i, uorder - 1, us, uknots)
                   for i in range(nu)])   # (nu, U)
    bv = np.stack([_bspline_basis(j, vorder - 1, vs, vknots)
                   for j in range(nv)])   # (nv, V)
    wp = P * w[..., None]
    num = np.einsum("jJ,iI,jid->IJd", bv, bu, wp)   # (U, V, 3)
    den = np.einsum("jJ,iI,ji->IJ", bv, bu, w)
    S = num / np.maximum(den[..., None], 1e-12)
    # normals by central differences
    du = np.gradient(S, axis=0)
    dv = np.gradient(S, axis=1)
    N = np.cross(du, dv)
    N /= np.maximum(np.linalg.norm(N, axis=-1, keepdims=True), 1e-12)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    uvs = np.stack([(uu.ravel() - u0) / max(u1 - u0, 1e-12),
                    (vv.ravel() - v0) / max(v1 - v0, 1e-12)], -1)
    return (S.reshape(-1, 3), N.reshape(-1, 3), uvs,
            _grid_faces(res_u, res_v))
