"""Wide-BVH traversal over wavefront ray batches: the plain PyTorch version.

Counterpart of BVHAccel::Intersect/IntersectP (accelerators/bvh.cpp:354-437):
per-lane short stacks, all rays step the 8-wide tree in lockstep inside one
Python `while` loop, children ordered near-first by slab-entry distance, and
per-ray node/leaf/primitive counters matching the reference's `GeneralStats`
(geometry.h:1078, bvh.cpp:379,421).

`intersect_wide` (single-level tables) and `intersect_two_level` (top tree +
treelets, accel/treelets.py) are what the CPU runs and what the CUDA kernels
(csrc/traverse_wide.cu, csrc/traverse_treelets.cu; wrappers in ops/) are held
against on the card: each kernel repeats its plain version's arithmetic
operation for operation."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpupt_torch.core.vecmath import ray_inv_d
from tpupt_torch.scene.device import DeviceScene, SceneStatics
from tpupt_torch.shapes.quadric import intersect_quadric, quadric_test_parts
from tpupt_torch.shapes.triangle import intersect_triangle, ray_permutation


class Hit(NamedTuple):
    """SoA hit record (SurfaceInteraction precursor)."""

    valid: torch.Tensor  # (N,) bool
    t: torch.Tensor      # (N,)
    prim: torch.Tensor   # (N,) i32 global prim id (tris then quadrics), -1 = miss
    b1: torch.Tensor     # (N,) triangle barycentric of p1
    b2: torch.Tensor     # (N,)
    p_obj: torch.Tensor  # (N,3) quadric object-space hit point


class TraversalStats(NamedTuple):
    """GeneralStats counterpart: per-ray traversal counters."""

    node_visits: torch.Tensor  # (N,) i32 wide-node traversals
    leaf_visits: torch.Tensor  # (N,) i32
    prim_tests: torch.Tensor   # (N,) i32 primitive intersection tests


WIDE_STACK = 48
META_EMPTY = -2**31
_BIG = 3.0e38

# optimal 19-comparator sorting network for 8 elements
_SORT8 = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
          (1, 2), (5, 6), (0, 4), (3, 7), (1, 5), (2, 6), (1, 4), (3, 6),
          (2, 4), (3, 5), (3, 4)]


def _xform_rows(prow, o, d):
    """Ray into the object space of the quadric whose w2o 3x4 (row-major)
    sits in cols 0-11 of each prim row. Written out term by term, not as a
    matrix product: a library product may fuse or reorder the three
    multiply-adds, and the CUDA kernel repeats exactly this order."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    o_obj = torch.stack(
        [prow[:, 4 * r] * ox + prow[:, 4 * r + 1] * oy + prow[:, 4 * r + 2] * oz
         + prow[:, 4 * r + 3] for r in range(3)], dim=-1)
    d_obj = torch.stack(
        [prow[:, 4 * r] * dx + prow[:, 4 * r + 1] * dy + prow[:, 4 * r + 2] * dz
         for r in range(3)], dim=-1)
    return o_obj, d_obj


def _interior_step(row, mrow, is_int, o, inv_d, t_cur, stack, sp):
    """8 slab tests of the node rows `row` (N,64) with metas `mrow` (N,8) for
    the lanes `is_int`; children that pass are ordered by slab-entry distance
    and pushed far-to-near onto `stack` (in place). Returns the new `sp`."""
    keys = []
    metas = []
    for c in range(8):
        lo = row[:, c * 6: c * 6 + 3]
        hi = row[:, c * 6 + 3: c * 6 + 6]
        t_lo = (lo - o) * inv_d
        t_hi = (hi - o) * inv_d
        t_near = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
        t_far = torch.amin(torch.maximum(t_lo, t_hi), dim=-1) * 1.0000004
        m = mrow[:, c]
        ok = is_int & (t_near <= t_far) & (t_far > 0.0) \
            & (t_near < t_cur) & (m != META_EMPTY)
        keys.append(torch.where(ok, t_near.clamp_min(0.0), _BIG))
        metas.append(m)
    # sort descending by key (farthest first) so nearest is pushed last
    for (a, b) in _SORT8:
        swap = keys[a] < keys[b]
        ka = torch.where(swap, keys[b], keys[a])
        kb = torch.where(swap, keys[a], keys[b])
        ma = torch.where(swap, metas[b], metas[a])
        mb = torch.where(swap, metas[a], metas[b])
        keys[a], keys[b], metas[a], metas[b] = ka, kb, ma, mb
    for c in range(8):
        push = keys[c] < _BIG
        slot = torch.where(push, sp, WIDE_STACK).clamp_max(WIDE_STACK)
        stack.scatter_(1, slot.long()[:, None], metas[c][:, None])
        sp = sp + push.to(torch.int32)
    return sp


def _leaf_step(prim_rows, prim_ints, st, is_leaf, l_first, l_count, o, d,
               perm, rec, touched=None):
    """Test the prim rows l_first .. l_first + l_count of the lanes `is_leaf`
    against their rays. `rec` = [t_cur, gid, ridx, b1, b2, tests] is
    replaced entry by entry (out of place) and returned."""
    t_cur, gid, ridx, b1, b2, tests = rec
    n_rows = prim_rows.shape[0]
    for k in range(st.max_leaf):
        valid = is_leaf & (k < l_count)
        idx = (l_first + k).clamp_max(n_rows - 1)
        prow = prim_rows[idx]   # (N, 32)
        pints = prim_ints[idx]
        if touched is not None:
            touched[idx[valid]] = True
        tests = tests + valid.to(torch.int32)
        p_gid = pints[:, 0]
        p_is_tri = pints[:, 1] == 1
        h_t, tt, _, tb1, tb2 = intersect_triangle(
            o, perm, prow[:, 0:3], prow[:, 3:6], prow[:, 6:9], t_cur)
        win = valid & p_is_tri & h_t & (tt > 1e-6) & (tt < t_cur)
        t_cur = torch.where(win, tt, t_cur)
        gid = torch.where(win, p_gid, gid)
        ridx = torch.where(win, idx, ridx)
        b1 = torch.where(win, tb1, b1)
        b2 = torch.where(win, tb2, b2)
        if st.n_spheres > 0:
            # unified quadric test from the packed row (w2o 3x4 in
            # cols 0-11, r/zmin/zmax/phimax 12-15, kind/q1/q2/sin/cos
            # 20-24; shapes/quadric.py)
            os_, dsph = _xform_rows(prow, o, d)
            h_s, ts_ = quadric_test_parts(
                prow[:, 20], prow[:, 12], prow[:, 13], prow[:, 14],
                prow[:, 15], prow[:, 21], prow[:, 22],
                prow[:, 23], prow[:, 24],
                os_[:, 0], os_[:, 1], os_[:, 2],
                dsph[:, 0], dsph[:, 1], dsph[:, 2], t_cur)
            win_s = valid & ~p_is_tri & h_s & (ts_ < t_cur)
            t_cur = torch.where(win_s, ts_, t_cur)
            gid = torch.where(win_s, p_gid, gid)
            ridx = torch.where(win_s, idx, ridx)
    return [t_cur, gid, ridx, b1, b2, tests]


def _deepest(sp) -> int:
    deepest = int(sp.max()) if sp.numel() else 0
    if deepest > WIDE_STACK:
        raise RuntimeError(
            f"wide-BVH stack overflow: depth {deepest} > {WIDE_STACK}")
    return deepest


@torch.no_grad()
def intersect_wide(ds: DeviceScene, st: SceneStatics, o, d, tmax,
                   any_hit: bool = False, touched=None):
    """Closest hit (or, with any_hit, the first occluder found) of each ray:
    one 256-byte node-row gather per step and one 128-byte prim-row gather
    per primitive test (see bvh.collapse_to_wide / device.pack_prim_rows for
    the layouts). Children are ordered by slab-entry distance with an
    8-element sorting network and pushed far-to-near. Lanes with tmax == 0
    never enter the loop. `touched` = (node mask (Nw,), prim mask (P,)) bool
    tensors, when given, get True at every row some ray read. Returns (Hit,
    TraversalStats)."""
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    perm = ray_permutation(d)
    inv_d = ray_inv_d(d)
    wide_meta = ds.wide_nodes[:, 48:56].view(i32)
    prim_ints = ds.prim_rows[:, 16:18].view(i32)

    t_cur = tmax.to(torch.float32).clone()
    # column WIDE_STACK absorbs the writes of lanes that push nothing
    stack = torch.zeros((n, WIDE_STACK + 1), dtype=i32, device=dev)
    sp = (t_cur > 0.0).to(i32)   # entry 0 = root node id 0; dead rays: empty
    rec = [t_cur, torch.full((n,), -1, dtype=i32, device=dev),
           torch.zeros(n, dtype=torch.int64, device=dev),
           torch.zeros(n, device=dev), torch.zeros(n, device=dev),
           torch.zeros(n, dtype=i32, device=dev)]
    nodes = torch.zeros(n, dtype=i32, device=dev)
    leaves = torch.zeros(n, dtype=i32, device=dev)

    while _deepest(sp) > 0:
        active = sp > 0
        top = (sp - 1).clamp_min(0).long()
        raw = stack.gather(1, top[:, None])[:, 0]
        sp = torch.where(active, sp - 1, sp)

        is_int = active & (raw >= 0)
        is_leaf = active & (raw < 0)
        node = torch.where(is_int, raw, 0).long()
        if touched is not None:
            touched[0][node[is_int]] = True

        # ---------- interior: one wide row gather, 8 slab tests ----------
        sp = _interior_step(ds.wide_nodes[node], wide_meta[node], is_int, o,
                            inv_d, rec[0], stack, sp)
        nodes = nodes + is_int.to(i32)
        leaves = leaves + is_leaf.to(i32)

        # ---------- leaf: packed prim rows ----------
        v = torch.where(is_leaf, -raw - 1, 0)
        rec = _leaf_step(ds.prim_rows, prim_ints, st, is_leaf, (v >> 6).long(),
                         v & 63, o, d, perm, rec,
                         None if touched is None else touched[1])
        if any_hit:
            sp = torch.where(rec[1] >= 0, 0, sp)

    t_cur, gid, ridx, b1, b2, tests = rec
    p_obj = quadric_hit_point(ds.prim_rows, st, o, d, t_cur, ridx)
    hit = Hit(valid=gid >= 0, t=t_cur, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, TraversalStats(nodes, leaves, tests)


@torch.no_grad()
def intersect_two_level(ds: DeviceScene, st: SceneStatics, o, d, tmax,
                        any_hit: bool = False, touched=None):
    """`intersect_wide` over the two-level tables of accel/treelets.py: the
    plain PyTorch version of the CUDA kernel csrc/traverse_treelets.cu.

    Each ray walks the top tree as `intersect_wide` walks the single-level
    one; a popped treelet reference -(tid) - 1 makes the ray enter treelet
    `tid`: it notes the treelet's first node and prim row and its stack
    height, pushes the treelet's root (local id 0) and walks the treelet on
    the same stack until the stack is back at that height. Top nodes and
    treelet nodes both count as node visits; entering a treelet counts
    nothing. `touched` = (top mask, treelet node mask, prim mask, treelet
    mask). Returns (Hit, TraversalStats)."""
    if not st.two_level:
        raise ValueError("the scene was uploaded without two-level tables")
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    perm = ray_permutation(d)
    inv_d = ray_inv_d(d)
    top_meta = ds.top_nodes[:, 48:56].view(i32)
    tl_meta = ds.tl_nodes[:, 48:56].view(i32)
    prim_ints = ds.tl_prims[:, 16:18].view(i32)
    offsets = ds.tl_offsets.long()

    t_cur = tmax.to(torch.float32).clone()
    stack = torch.zeros((n, WIDE_STACK + 1), dtype=i32, device=dev)
    sp = (t_cur > 0.0).to(i32)   # entry 0 = top node id 0
    rec = [t_cur, torch.full((n,), -1, dtype=i32, device=dev),
           torch.zeros(n, dtype=torch.int64, device=dev),
           torch.zeros(n, device=dev), torch.zeros(n, device=dev),
           torch.zeros(n, dtype=i32, device=dev)]
    nodes = torch.zeros(n, dtype=i32, device=dev)
    leaves = torch.zeros(n, dtype=i32, device=dev)
    in_tl = torch.zeros(n, dtype=torch.bool, device=dev)
    base = torch.zeros(n, dtype=i32, device=dev)   # stack height at entry
    noff = torch.zeros(n, dtype=torch.int64, device=dev)
    poff = torch.zeros(n, dtype=torch.int64, device=dev)

    while _deepest(sp) > 0:
        active = sp > 0
        in_tl = in_tl & (sp > base)
        top = (sp - 1).clamp_min(0).long()
        raw = stack.gather(1, top[:, None])[:, 0]
        sp = torch.where(active, sp - 1, sp)

        is_ref = active & ~in_tl & (raw < 0)
        is_top = active & ~in_tl & (raw >= 0)
        is_tnode = active & in_tl & (raw >= 0)
        is_leaf = active & in_tl & (raw < 0)

        # ---------- treelet reference: enter, push the local root ----------
        tid = torch.where(is_ref, -raw - 1, 0).long()
        off = offsets[tid]
        noff = torch.where(is_ref, off[:, 0], noff)
        poff = torch.where(is_ref, off[:, 1], poff)
        base = torch.where(is_ref, sp, base)
        slot = torch.where(is_ref, sp, WIDE_STACK).clamp_max(WIDE_STACK)
        stack.scatter_(1, slot.long()[:, None],
                       torch.zeros((n, 1), dtype=i32, device=dev))
        sp = sp + is_ref.to(i32)
        in_tl = in_tl | is_ref

        # ---------- interior of either level: one row, 8 slab tests --------
        top_id = torch.where(is_top, raw, 0).long()
        tl_id = torch.where(is_tnode, noff + raw, 0)
        if touched is not None:
            touched[0][top_id[is_top]] = True
            touched[1][tl_id[is_tnode]] = True
            touched[3][tid[is_ref]] = True
        row = torch.where(is_top[:, None], ds.top_nodes[top_id],
                          ds.tl_nodes[tl_id])
        mrow = torch.where(is_top[:, None], top_meta[top_id], tl_meta[tl_id])
        is_int = is_top | is_tnode
        sp = _interior_step(row, mrow, is_int, o, inv_d, rec[0], stack, sp)
        nodes = nodes + is_int.to(i32)
        leaves = leaves + is_leaf.to(i32)

        # ---------- leaf of a treelet ----------
        v = torch.where(is_leaf, -raw - 1, 0)
        rec = _leaf_step(ds.tl_prims, prim_ints, st, is_leaf,
                         poff + (v >> 6), v & 63, o, d, perm, rec,
                         None if touched is None else touched[2])
        if any_hit:
            sp = torch.where(rec[1] >= 0, 0, sp)

    t_cur, gid, ridx, b1, b2, tests = rec
    p_obj = quadric_hit_point(ds.tl_prims, st, o, d, t_cur, ridx)
    hit = Hit(valid=gid >= 0, t=t_cur, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, TraversalStats(nodes, leaves, tests)


def quadric_hit_point(prim_rows, st, o, d, t, ridx):
    """Object-space hit point of the winning row of `prim_rows`, for quadric
    shading; reconstructed after the loop (zeros when the scene has no
    quadrics)."""
    if st.n_spheres == 0:
        return o.new_zeros((o.shape[0], 3))
    o_obj, d_obj = _xform_rows(prim_rows[ridx.long()], o, d)
    return o_obj + t[:, None] * d_obj


def intersect_p(ds: DeviceScene, st: SceneStatics, o, d, tmax):
    """Shadow-ray occlusion test (BVHAccel::IntersectP, bvh.cpp:398)."""
    hit, stats = intersect_wide(ds, st, o, d, tmax, any_hit=True)
    return hit.valid, stats


@torch.no_grad()
def intersect_brute(ds: DeviceScene, st: SceneStatics, o, d, tmax):
    """O(N*P) ground-truth intersector for validation (tests only)."""
    n = o.shape[0]
    dev = o.device
    perm = ray_permutation(d)
    t_cur = tmax.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(n, device=dev)
    b2 = torch.zeros(n, device=dev)
    p_obj = torch.zeros((n, 3), device=dev)
    for tid in range(st.n_tris):
        h, tt, _, tb1, tb2 = intersect_triangle(
            o, perm, ds.tri_p0[tid], ds.tri_p1[tid], ds.tri_p2[tid], t_cur)
        win = h & (tt > 1e-6) & (tt < t_cur)
        t_cur = torch.where(win, tt, t_cur)
        prim = torch.where(win, tid, prim)
        b1 = torch.where(win, tb1, b1)
        b2 = torch.where(win, tb2, b2)
    for sid in range(st.n_spheres):
        h, ts_, po = intersect_quadric(
            o, d, t_cur, ds.sph_w2o[sid], ds.sph_kind[sid],
            ds.sph_radius[sid], ds.sph_zmin[sid], ds.sph_zmax[sid],
            ds.sph_phimax[sid], ds.sph_q1[sid], ds.sph_q2[sid])
        win = h & (ts_ < t_cur)
        t_cur = torch.where(win, ts_, t_cur)
        prim = torch.where(win, st.n_tris + sid, prim)
        p_obj = torch.where(win[:, None], po, p_obj)
    return Hit(prim >= 0, t_cur, prim, b1, b2, p_obj)
