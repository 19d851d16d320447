"""Host-side BVH construction -> flat node tensors for device traversal.

Flat-array counterpart of the reference BVH (src/accelerators/bvh.cpp): the
thesis construction there is an exact sweep-SAH (bvh.cpp:242-321) flattened to a
`LinearBVHNode` array (bvh.cpp:123-150). Here the build itself is a fully
vectorized LBVH: Morton-code radix tree (Karras 2012 per-node parallel
construction — the same family as the reference's HLBVH, bvhOld.cpp:82-94)
with bottom-up AABB fitting and SAH-driven leaf collapse, emitted in
depth-first `LinearBVHNode` layout (first child implicit at i+1, second child
by offset) for stack traversal with near-child ordering.

All outputs are flat numpy arrays ready for upload.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BVHArrays:
    """Flat LinearBVHNode-style SoA (bvh.h LinearBVHNode counterpart)."""

    lo: np.ndarray      # (N,3) f32 node bounds min
    hi: np.ndarray      # (N,3) f32 node bounds max
    right: np.ndarray   # (N,) i32 second-child index (interior); undefined leaf
    first: np.ndarray   # (N,) i32 first prim (leaf); undefined interior
    count: np.ndarray   # (N,) i32 prim count; 0 = interior
    axis: np.ndarray    # (N,) i32 split axis for dirIsNeg ordering
    prim_ids: np.ndarray  # (P,) i32 permutation into the scene prim tables

    @property
    def n_nodes(self) -> int:
        return len(self.count)


# ------------------------- morton utilities --------------------------------


def _expand_bits_10(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (bvhOld.cpp LeftShift3 analog)."""
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x030000FF)
    v = (v | (v << 8)) & np.uint64(0x0300F00F)
    v = (v | (v << 4)) & np.uint64(0x030C30C3)
    v = (v | (v << 2)) & np.uint64(0x09249249)
    return v


def morton3d(p01: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points normalized to [0,1)^3."""
    q = np.clip(p01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (
        (_expand_bits_10(q[:, 0]) << np.uint64(2))
        | (_expand_bits_10(q[:, 1]) << np.uint64(1))
        | _expand_bits_10(q[:, 2])
    )


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint64 (exact via 32-bit halves)."""
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v):
        out = np.full(v.shape, 32, np.int64)
        nz = v != 0
        out[nz] = 31 - np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int64)
        return out

    h = clz32(hi)
    return np.where(hi != 0, h, 32 + clz32(lo))


# ------------------------- radix-tree build --------------------------------


def _build_radix_tree(keys: np.ndarray):
    """Karras 2012: for each internal node i in [0, n-2], find its range and
    split, fully vectorized. Returns (left, right, first, last) where child
    encoding is c >= 0 internal id, c < 0 leaf id -(c+1)."""
    n = len(keys)
    if n == 1:
        return (np.array([], np.int64),) * 4

    def delta(i, j):
        """Common-prefix length; -1 out of range. i, j int64 arrays."""
        ok = (j >= 0) & (j < n)
        jj = np.clip(j, 0, n - 1)
        d = _clz64(keys[i] ^ keys[jj])
        return np.where(ok, d, -1)

    i = np.arange(n - 1, dtype=np.int64)
    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # doubling to find range-length upper bound
    l_max = np.full(n - 1, 2, np.int64)
    while True:
        probe = delta(i, i + l_max * d) > delta_min
        if not probe.any():
            break
        l_max = np.where(probe, l_max * 2, l_max)
        if (l_max > 2 * n).all():
            break

    # binary search exact other-end distance l
    l = np.zeros(n - 1, np.int64)
    t = l_max // 2
    while (t > 0).any():
        tt = np.maximum(t, 1)
        cond = (t > 0) & (delta(i, i + (l + tt) * d) > delta_min)
        l = np.where(cond, l + tt, l)
        t = t // 2
    j = i + l * d
    delta_node = delta(i, j)

    # binary search split position s (ceil-halving: t = ceil(l/2), ..., 1)
    s = np.zeros(n - 1, np.int64)
    t = (l + 1) // 2
    active = np.ones(n - 1, bool)
    while active.any():
        cond = active & (delta(i, i + (s + t) * d) > delta_node)
        s = np.where(cond, s + t, s)
        active = active & (t > 1)
        t = np.where(active, (t + 1) // 2, t)
    gamma = i + s * d + np.minimum(d, 0)

    lo_r = np.minimum(i, j)
    hi_r = np.maximum(i, j)
    left = np.where(lo_r == gamma, -(gamma + 1), gamma)
    right = np.where(hi_r == gamma + 1, -(gamma + 2), gamma + 1)
    return left, right, lo_r, hi_r


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              max_leaf_prims: int = 4,
              isect_cost: float = 8.0, traversal_cost: float = 1.0) -> BVHArrays:
    """Build the flat BVH. Costs default to the reference's bvh.cpp:531-537
    (intersectcost=8, traversalcost=1, maxnodeprims=4)."""
    n = len(prim_lo)
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    if n == 0:
        return BVHArrays(
            lo=np.zeros((1, 3), np.float32), hi=np.zeros((1, 3), np.float32),
            right=np.zeros(1, np.int32), first=np.zeros(1, np.int32),
            count=np.zeros(1, np.int32), axis=np.zeros(1, np.int32),
            prim_ids=np.zeros(0, np.int32))

    centroid = 0.5 * (prim_lo + prim_hi)
    cb_lo = centroid.min(0)
    cb_hi = centroid.max(0)
    extent = np.where(cb_hi - cb_lo > 0, cb_hi - cb_lo, 1.0)
    codes = morton3d((centroid - cb_lo) / extent)
    keys = (codes << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]

    if n == 1:
        lo = prim_lo.astype(np.float32)
        hi = prim_hi.astype(np.float32)
        return BVHArrays(lo=lo, hi=hi, right=np.zeros(1, np.int32),
                         first=np.zeros(1, np.int32), count=np.ones(1, np.int32),
                         axis=np.zeros(1, np.int32),
                         prim_ids=order.astype(np.int32))

    left, right, first, last = _build_radix_tree(keys)
    slo = prim_lo[order]
    shi = prim_hi[order]

    # --- bottom-up AABB fit + SAH subtree cost, <=64 passes ---
    ni = n - 1
    node_lo = np.full((ni, 3), np.inf)
    node_hi = np.full((ni, 3), -np.inf)
    node_cost = np.zeros(ni)
    ready = np.zeros(ni, bool)

    def child_bounds_cost(c):
        is_leaf = c < 0
        leaf_idx = -(c + 1)
        ci = np.where(is_leaf, 0, c)
        clo = np.where(is_leaf[:, None], slo[np.where(is_leaf, leaf_idx, 0)], node_lo[ci])
        chi = np.where(is_leaf[:, None], shi[np.where(is_leaf, leaf_idx, 0)], node_hi[ci])
        ccost = np.where(is_leaf, isect_cost, node_cost[np.where(is_leaf, 0, c)])
        cready = np.where(is_leaf, True, ready[ci])
        return clo, chi, ccost, cready

    for _ in range(70):
        llo, lhi, lcost, lready = child_bounds_cost(left)
        rlo, rhi, rcost, rready = child_bounds_cost(right)
        can = lready & rready & ~ready
        if not can.any():
            break
        ulo = np.minimum(llo, rlo)
        uhi = np.maximum(lhi, rhi)
        area = _surface_area(ulo, uhi)
        larea = _surface_area(llo, lhi)
        rarea = _surface_area(rlo, rhi)
        safe = np.where(area > 0, area, 1.0)
        cost = traversal_cost + (larea * lcost + rarea * rcost) / safe
        node_lo[can] = ulo[can]
        node_hi[can] = uhi[can]
        node_cost[can] = cost[can]
        ready |= can

    if not ready.all():
        raise RuntimeError("BVH bottom-up pass did not converge")

    # --- SAH leaf collapse: subtree -> leaf when cheaper and small enough ---
    counts = last - first + 1
    leaf_cost = counts * isect_cost
    collapse = (counts <= max_leaf_prims) & (leaf_cost <= node_cost)

    # --- DFS flatten (explicit stack; bvh.cpp:335 flattenBVHTree analog) ---
    max_nodes = 2 * n - 1
    out_lo = np.zeros((max_nodes, 3), np.float32)
    out_hi = np.zeros((max_nodes, 3), np.float32)
    out_right = np.zeros(max_nodes, np.int32)
    out_first = np.zeros(max_nodes, np.int32)
    out_count = np.zeros(max_nodes, np.int32)
    out_axis = np.zeros(max_nodes, np.int32)

    nxt = 0
    # stack entries: (node_id_internal_or_leaf_encoded, parent_slot_for_right)
    stack = [(0, -1)]
    while stack:
        enc, parent_slot = stack.pop()
        slot = nxt
        nxt += 1
        if parent_slot >= 0:
            out_right[parent_slot] = slot
        if enc < 0:  # singleton leaf from radix tree
            li = -(enc + 1)
            out_lo[slot] = slo[li]
            out_hi[slot] = shi[li]
            out_first[slot] = li
            out_count[slot] = 1
            continue
        if collapse[enc]:
            out_lo[slot] = node_lo[enc]
            out_hi[slot] = node_hi[enc]
            out_first[slot] = first[enc]
            out_count[slot] = counts[enc]
            continue
        out_lo[slot] = node_lo[enc]
        out_hi[slot] = node_hi[enc]
        out_count[slot] = 0
        d = node_hi[enc] - node_lo[enc]
        out_axis[slot] = int(np.argmax(d))
        # push right first so left lands at slot+1
        stack.append((right[enc], slot))
        stack.append((left[enc], -1))

    return BVHArrays(
        lo=out_lo[:nxt], hi=out_hi[:nxt], right=out_right[:nxt],
        first=out_first[:nxt], count=out_count[:nxt], axis=out_axis[:nxt],
        prim_ids=order.astype(np.int32),
    )


WIDE_WIDTH = 8
META_EMPTY = -2**31  # empty child slot sentinel (leaf encodings stay > this)


def subtree_ranges(b: BVHArrays):
    """Contiguous prim range [first, last] per binary node (both build paths
    emit DFS-partitioned prim_ids, so every subtree is a contiguous run)."""
    n = b.n_nodes
    first = np.zeros(n, np.int64)
    last = np.zeros(n, np.int64)
    # reverse-DFS: children appear after parents in the flat layout, so a
    # backward sweep sees children before their parent
    for i in range(n - 1, -1, -1):
        if b.count[i] > 0:
            first[i] = b.first[i]
            last[i] = b.first[i] + b.count[i] - 1
        else:
            l, r = i + 1, int(b.right[i])
            first[i] = min(first[l], first[r])
            last[i] = max(last[l], last[r])
    return first, last


def collapse_to_wide(b: BVHArrays, width: int = WIDE_WIDTH,
                     leaf_merge: int = 4):
    """Collapse the binary BVH into a width-ary BVH packed one node per
    64-float row: a single 256-byte row gather per
    traversal step fetches all children's bounds + metadata (one row
    instead of `width` per-child gathers;
    cf. SURVEY.md §7 'flattened node tensors').

    Row layout (f32[64]): [8 x (lo.xyz, hi.xyz) = 48][8 x meta(bitcast i32)]
    [8 pad]. meta >= 0: child wide-node id; META_EMPTY: empty slot; other
    meta < 0: leaf, encoding -(first * 64 + count) - 1.

    Returns (nodes (Nw, 64) f32, root_meta) — root_meta handles the
    degenerate all-leaf case."""
    n_nodes = b.n_nodes
    if n_nodes == 1:
        # single node; make one wide row whose child 0 is that leaf
        row = np.zeros((1, 64), np.float32)
        row[0, 0:3] = b.lo[0]
        row[0, 3:6] = b.hi[0]
        meta = np.full(width, META_EMPTY, np.int32)
        meta[0] = -(int(b.first[0]) * 64 + int(b.count[0])) - 1
        row[0, 48:56] = meta.view(np.float32)
        for c in range(1, width):
            row[0, c * 6 : c * 6 + 3] = np.inf
            row[0, c * 6 + 3 : c * 6 + 6] = -np.inf
        return row, None

    lo, hi, right, first, count = b.lo, b.hi, b.right, b.first, b.count
    # packet economics: merge small subtrees into fat leaves regardless of
    # scalar SAH (sweep-SAH's 1-prim leaves would explode the node count),
    # but keep leaves SMALL: each leaf pop runs max_leaf statically
    # unrolled ~110-vector-op packet prim tests, which dominate traversal
    # time - killeroo whole-render measured 1378/1266/1317 ms at
    # leaf_merge 8/4/6 (interior pops after the dense-tile load are much
    # cheaper than the prim tests they avoid)
    sub_first, sub_last = subtree_ranges(b)
    sub_count = sub_last - sub_first + 1

    def is_leaf_slot(i):
        return count[i] > 0 or sub_count[i] <= leaf_merge

    def leaf_meta(i):
        if count[i] > 0:
            return -(int(first[i]) * 64 + int(count[i])) - 1
        return -(int(sub_first[i]) * 64 + int(sub_count[i])) - 1

    # Collect up to `width` grandchildren by splitting the largest-area
    # interior slot repeatedly (greedy SAH-area heuristic).
    def expand(i):
        slots = [i + 1, int(right[i])]
        while len(slots) < width:
            best, best_area = -1, -1.0
            for k, s in enumerate(slots):
                if not is_leaf_slot(s):
                    a = float(_surface_area(lo[s], hi[s]))
                    if a > best_area:
                        best, best_area = k, a
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([s + 1, int(right[s])])
        return slots

    rows = []
    # wide node ids assigned in BFS order
    wide_id = {0: 0}
    queue = [0]
    rows.append(None)
    while queue:
        i = queue.pop()
        slots = expand(i)
        row = np.zeros(64, np.float32)
        meta = np.full(width, META_EMPTY, np.int32)
        for c in range(width):
            if c < len(slots):
                s = slots[c]
                row[c * 6 : c * 6 + 3] = lo[s]
                row[c * 6 + 3 : c * 6 + 6] = hi[s]
                if is_leaf_slot(s):
                    meta[c] = leaf_meta(s)
                else:
                    wid = len(rows)
                    rows.append(None)
                    wide_id[s] = wid
                    meta[c] = wid
                    queue.append(s)
            else:
                row[c * 6 : c * 6 + 3] = np.inf
                row[c * 6 + 3 : c * 6 + 6] = -np.inf
        row[48:56] = meta.view(np.float32)
        rows[wide_id[i]] = row
    return np.stack(rows), None


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


def scene_prim_bounds(scene) -> tuple:
    """Per-prim AABBs in global prim-id order ([0,T) tris, [T,T+S) spheres)."""
    tris = scene.triangles
    los, his = [], []
    if tris.count:
        p = np.stack([tris.p0, tris.p1, tris.p2], 1)  # (T,3,3)
        if tris.has_motion:
            # conservative shutter-union bounds per prim: the vertex-lerp
            # motion path sweeps p..p+dp, so the union of the two key
            # positions bounds every intermediate time (linear motion)
            pe = np.stack([tris.p0 + tris.dp0, tris.p1 + tris.dp1,
                           tris.p2 + tris.dp2], 1)
            p = np.concatenate([p, pe], 1)  # (T,6,3)
        los.append(p.min(1))
        his.append(p.max(1))
    if scene.spheres.count:
        from tpupt_torch.scene.flatten import _sphere_world_bounds

        slo, shi = _sphere_world_bounds(scene.spheres)
        los.append(slo)
        his.append(shi)
    if not los:
        return np.zeros((0, 3)), np.zeros((0, 3))
    return np.concatenate(los), np.concatenate(his)


def build_bvh_split(prim_lo: np.ndarray, prim_hi: np.ndarray,
                    method: str = "middle",
                    max_leaf_prims: int = 4) -> BVHArrays:
    """Middle / EqualCounts split methods of the research comparator
    (bvhOld.h:58-65 SplitMethod::Middle / ::EqualCounts): recursive
    top-down build splitting the centroid bounds at the midpoint of the
    widest axis (middle) or at the median primitive (equalcounts). These
    exist for A/B comparisons against SAH, not performance."""
    n = len(prim_lo)
    prim_lo = np.asarray(prim_lo, np.float64)
    prim_hi = np.asarray(prim_hi, np.float64)
    if n == 0:
        return build_bvh(prim_lo, prim_hi, max_leaf_prims)
    cent = 0.5 * (prim_lo + prim_hi)

    lo_l, hi_l, right_l, first_l, count_l, axis_l = [], [], [], [], [], []
    prim_ids: list = []

    def emit(idx):
        i = len(lo_l)
        lo_l.append(prim_lo[idx].min(0))
        hi_l.append(prim_hi[idx].max(0))
        right_l.append(0)
        first_l.append(0)
        count_l.append(0)
        axis_l.append(0)
        return i

    def rec(idx):
        i = emit(idx)
        if len(idx) <= max_leaf_prims:
            first_l[i] = len(prim_ids)
            count_l[i] = len(idx)
            prim_ids.extend(idx.tolist())
            return i
        c = cent[idx]
        ext = c.max(0) - c.min(0)
        ax = int(np.argmax(ext))
        axis_l[i] = ax
        if ext[ax] <= 1e-12:
            # degenerate spread: fall back to an equal-count split
            order = np.argsort(c[:, ax], kind="stable")
            half = len(idx) // 2
            left, right = idx[order[:half]], idx[order[half:]]
        elif method == "middle":
            mid = 0.5 * (c[:, ax].min() + c[:, ax].max())
            mask = c[:, ax] < mid
            left, right = idx[mask], idx[~mask]
            if len(left) == 0 or len(right) == 0:
                order = np.argsort(c[:, ax], kind="stable")
                half = len(idx) // 2
                left, right = idx[order[:half]], idx[order[half:]]
        else:  # equalcounts (nth_element median, bvhOld SplitEqualCounts)
            order = np.argsort(c[:, ax], kind="stable")
            half = len(idx) // 2
            left, right = idx[order[:half]], idx[order[half:]]
        rec(left)
        right_l[i] = rec(right)
        return i

    import sys as _sys

    old = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old, 10000 + n))
    try:
        rec(np.arange(n))
    finally:
        _sys.setrecursionlimit(old)
    return BVHArrays(
        lo=np.asarray(lo_l, np.float32), hi=np.asarray(hi_l, np.float32),
        right=np.asarray(right_l, np.int32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        axis=np.asarray(axis_l, np.int32),
        prim_ids=np.asarray(prim_ids, np.int32))
