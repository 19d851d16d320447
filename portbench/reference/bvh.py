"""The reference's own ray-triangle queries: a binary tree over triangles
sorted by the Morton code of their centroids, four triangles a leaf, laid
out as a complete binary heap (node j has children 2j and 2j+1), and a
near-first stack walk per ray, vectorised over the rays still walking.

The triangle test is the watertight one (Woop, Benthin and Wald 2013;
pbrt-v3 Triangle::Intersect): translate to the ray origin, permute the
ray's dominant axis to z, shear, signed edge functions, and reject t <= 0
or t >= tmax without dividing. A hit closer than 1e-6 is no hit."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

LEAF = 4
T_MIN = 1e-6
BIG = 0.05     # a triangle wider than this share of the scene is not in
#                the tree: every ray tests it first (floors and walls)


@dataclass
class Tree:
    depth: int                # leaves are nodes [2^depth, 2^(depth+1))
    lo: torch.Tensor          # (2^(depth+1), 3) node boxes; index 0 unused
    hi: torch.Tensor
    leaf_tris: torch.Tensor   # (2^depth, LEAF, 9) vertices; padding never hits
    leaf_ids: torch.Tensor    # (2^depth, LEAF) triangle ids, -1 for padding
    big_tris: torch.Tensor    # (B, 9) vertices of the triangles left out
    big_ids: torch.Tensor     # (B,)


def _morton(c: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points already scaled to [0, 1023]."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return (spread(c[:, 0]) << 2) | (spread(c[:, 1]) << 1) | spread(c[:, 2])


def build(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> Tree:
    a, b, c = (x.cpu().numpy() for x in (p0, p1, p2))
    ext = np.maximum(np.maximum(a, b), c) - np.minimum(np.minimum(a, b), c)
    pts = np.concatenate([a, b, c])
    big = ext.max(1) > BIG * (pts.max(0) - pts.min(0)).max()
    big_ids = np.nonzero(big)[0]
    keep = np.nonzero(~big)[0]
    big_tris = np.concatenate([a, b, c], 1)[big_ids]
    a, b, c = a[keep], b[keep], c[keep]
    n = len(a)
    cen = (a + b + c) / 3.0
    lo, hi = (cen.min(0), cen.max(0)) if n else (np.zeros(3), np.ones(3))
    q = ((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64)
    order = np.argsort(_morton(q), kind="stable")
    n_leaves = max(1, -(-n // LEAF))
    depth = max(0, int(np.ceil(np.log2(n_leaves))))
    cap = (1 << depth) * LEAF
    ids = np.full(cap, -1, np.int64)
    ids[:n] = keep[order]
    ids = ids.reshape(1 << depth, LEAF)
    verts = np.zeros((len(ext) + 1, 9), np.float32)   # the last: padding
    verts[keep] = np.concatenate([a, b, c], 1)
    leaf_tris = verts[ids]
    # an empty box is NaN: every comparison of the slab test fails on it,
    # and fmin / fmax leave it out of a parent's box
    tri_lo = np.full((len(ext) + 1, 3), np.nan, np.float32)
    tri_hi = np.full((len(ext) + 1, 3), np.nan, np.float32)
    tri_lo[keep] = np.minimum(np.minimum(a, b), c)
    tri_hi[keep] = np.maximum(np.maximum(a, b), c)
    level_lo = np.fmin.reduce(tri_lo[ids], axis=1)
    level_hi = np.fmax.reduce(tri_hi[ids], axis=1)
    node_lo = np.full(((2 << depth), 3), np.nan, np.float32)
    node_hi = np.full(((2 << depth), 3), np.nan, np.float32)
    for lev in range(depth, -1, -1):
        node_lo[1 << lev: 2 << lev] = level_lo
        node_hi[1 << lev: 2 << lev] = level_hi
        level_lo = np.fmin(level_lo[0::2], level_lo[1::2])
        level_hi = np.fmax(level_hi[0::2], level_hi[1::2])
    dev = p0.device
    return Tree(depth=depth, lo=torch.from_numpy(node_lo).to(dev),
                hi=torch.from_numpy(node_hi).to(dev),
                leaf_tris=torch.from_numpy(leaf_tris).to(dev),
                leaf_ids=torch.from_numpy(ids).to(dev),
                big_tris=torch.from_numpy(big_tris).to(dev),
                big_ids=torch.from_numpy(big_ids).to(dev))


def _axis(v, k):
    """v[..., k] for a per-ray axis k of shape v.shape[:-1]."""
    return torch.gather(v, -1, k[..., None])[..., 0]


def _tri_test(o, kx, ky, kz, sx, sy, sz, v0, v1, v2, tmax):
    """Watertight test of rays against triangles, all arguments broadcast
    to one leading shape: (hit, t, b1, b2) with barycentrics of v1 and
    v2."""
    a0, a1, a2 = v0 - o, v1 - o, v2 - o
    a0x, a0y, a0z = _axis(a0, kx), _axis(a0, ky), _axis(a0, kz)
    a1x, a1y, a1z = _axis(a1, kx), _axis(a1, ky), _axis(a1, kz)
    a2x, a2y, a2z = _axis(a2, kx), _axis(a2, ky), _axis(a2, kz)
    x0, y0 = a0x - sx * a0z, a0y - sy * a0z
    x1, y1 = a1x - sx * a1z, a1y - sy * a1z
    x2, y2 = a2x - sx * a2z, a2y - sy * a2z
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    same = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
            | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0)))
    det = e0 + e1 + e2
    ts = e0 * (sz * a0z) + e1 * (sz * a1z) + e2 * (sz * a2z)
    t_ok = torch.where(det > 0, (ts > 0) & (ts < tmax * det),
                       (ts < 0) & (ts > tmax * det))
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    t = ts * inv
    hit = same & (det != 0) & t_ok & (t > T_MIN) & (t < tmax)
    return hit, t, e1 * inv, e2 * inv


def _permutation(d):
    ad = d.abs()
    kz = torch.where((ad[:, 0] >= ad[:, 1]) & (ad[:, 0] >= ad[:, 2]), 0,
                     torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    dz = _axis(d, kz)
    swap = dz < 0
    kx, ky = torch.where(swap, ky, kx), torch.where(swap, kx, ky)
    return kx, ky, kz, _axis(d, kx) / dz, _axis(d, ky) / dz, 1.0 / dz


def _closest(o, perm, tris, ids, tmax):
    """Closest hit of each ray among its row of triangles: tris (m, K, 9),
    ids (m, K); (hit, t, prim, b1, b2), the first of equal distances."""
    k = tris.shape[1]
    pm = [x[:, None].expand(-1, k) for x in perm]
    h, t, b1, b2 = _tri_test(o[:, None, :], *pm, tris[..., 0:3],
                             tris[..., 3:6], tris[..., 6:9],
                             tmax[:, None])
    t = torch.where(h, t, torch.inf)
    best = t.argmin(1, keepdim=True)
    pick = lambda x: x.gather(1, best)[:, 0]  # noqa: E731
    return pick(h), pick(t), pick(ids), pick(b1), pick(b2)


def _box_entry(lo, hi, o, inv_d, tmax):
    """Entry distance of the slab test, +inf where the box is missed."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1).amax(-1).clamp_min(0.0)
    tf = torch.maximum(t0, t1).amin(-1)
    ok = (tn <= tf * (1 + 2e-7)) & (tn < tmax)
    return torch.where(ok, tn, torch.inf)


@torch.no_grad()
def intersect(tree: Tree, o, d, tmax, any_hit: bool = False):
    """(valid, t, prim, b1, b2) of rays (o, d) over [T_MIN, tmax); any_hit
    stops a ray at its first hit. A ray with tmax <= 0 is not walked."""
    n = o.shape[0]
    dev = o.device
    t_best = tmax.clone().float()
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(n, device=dev)
    b2 = torch.zeros(n, device=dev)
    inv_all = torch.where(d.abs() < 1e-30, torch.sign(d) * 1e30 + 1e30,
                          1.0 / d)
    perm_all = _permutation(d)
    if len(tree.big_ids):
        nb = len(tree.big_ids)
        h, tt, pid, bb1, bb2 = _closest(
            o, perm_all, tree.big_tris[None].expand(n, nb, 9),
            tree.big_ids[None].expand(n, nb), t_best)
        t_best = torch.where(h, tt, t_best)
        prim = torch.where(h, pid, prim)
        b1 = torch.where(h, bb1, b1)
        b2 = torch.where(h, bb2, b2)
    depth = tree.depth
    first_leaf = 1 << depth
    stack = torch.zeros((n, depth + 2), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.ones(n, dtype=torch.int64, device=dev)
    walk = (tmax > 0) & (_box_entry(tree.lo[1], tree.hi[1], o, inv_all,
                                    t_best) < torch.inf)
    if any_hit:
        walk = walk & (prim < 0)
    rays = torch.nonzero(walk)[:, 0]
    while rays.numel():
        j = node[rays]
        leaf = j >= first_leaf
        pop = leaf.clone()
        lr = rays[leaf]
        if lr.numel():
            leaf_j = j[leaf] - first_leaf
            h, tt, pid, bb1, bb2 = _closest(
                o[lr], [x[lr] for x in perm_all], tree.leaf_tris[leaf_j],
                tree.leaf_ids[leaf_j], t_best[lr])
            hr = lr[h]
            t_best[hr] = tt[h]
            prim[hr] = pid[h]
            b1[hr] = bb1[h]
            b2[hr] = bb2[h]
        ir = rays[~leaf]
        if ir.numel():
            ji = j[~leaf]
            oi, inv_i, tb = o[ir], inv_all[ir], t_best[ir]
            tl = _box_entry(tree.lo[2 * ji], tree.hi[2 * ji], oi, inv_i, tb)
            th = _box_entry(tree.lo[2 * ji + 1], tree.hi[2 * ji + 1], oi,
                            inv_i, tb)
            near_l = tl <= th
            near = torch.where(near_l, 2 * ji, 2 * ji + 1)
            far = torch.where(near_l, 2 * ji + 1, 2 * ji)
            hit_n = torch.minimum(tl, th) < torch.inf
            hit_f = torch.maximum(tl, th) < torch.inf
            push = ir[hit_f]
            stack[push, sp[push]] = far[hit_f]
            sp[push] += 1
            node[ir] = torch.where(hit_n, near, ji)
            pop[~leaf] = ~hit_n
        pr = rays[pop]
        empty = sp[pr] == 0
        top = (sp[pr] - 1).clamp_min(0)
        node[pr] = torch.where(empty, 0, stack[pr, top])
        sp[pr] = top
        done = node[rays] == 0
        if any_hit:
            done = done | (prim[rays] >= 0)
        rays = rays[~done]
    valid = prim >= 0
    return valid, t_best, prim, b1, b2
