"""kd-tree / RBSP / BSP accelerators: host-side tables and the plain PyTorch
walker.

Counterpart of the reference's GenericBSP-family traversals
(kdtreeaccel.cpp:380-500, rbsp.cpp:405-477, BSPKd.h:59-83): a kd-tree is the
special case of a restricted BSP whose direction set is the three coordinate
axes, so ONE walker serves every tree of the thesis family. The split-plane
distance is computed by projecting the ray onto the node's direction
(rbsp.cpp intersectInterior).

Node arrays (from the native builders, tpupt_torch.native):
  flags  (K,) i32 : direction index, == n_dirs for leaves (kd / RBSP);
                    0 interior / 1 leaf for the unrestricted-BSP family
  split  (K,) f32 : plane offset t (plane: dot(p, dir) = t)
  above  (K,) i32 : above-child id (below child = node + 1); a leaf's first
                    row in `prim_rows`
  nprims (K,) i32 : leaf prim count
  ndir   (K,3) f32: per-node direction (unrestricted-BSP family only)
These and the 4-aligned leaf runs of `prim_rows` / `prim_ids` are array-equal
to the JAX package's, so both packages walk the same tree. They stay on the
host: `node_rows` packs them into one 32-byte row a node, the table that the
plain walker here and the CUDA kernel (csrc/traverse_kdbsp.cu) both read.

`intersect_kdbsp` is what the CPU runs and what the kernel is held against on
the card: the kernel repeats its arithmetic operation for operation.
"""

from __future__ import annotations

import numpy as np
import torch

from tpupt_torch.accel.traverse import (Hit, TraversalStats, _leaf_step,
                                        quadric_hit_point)
from tpupt_torch.core.vecmath import ray_inv_d
from tpupt_torch.shapes.triangle import ray_permutation

# capacity of the per-ray (node, tmin, tmax) stack, in the plain walker and in
# the kernel alike; a depth-first walk pushes at most one entry per level
KD_STACK = 64
# the 16 zero rows that end the JAX package's prim table (kept for equality)
_TAIL_ROWS = 16


# ---------------------------------------------------------------------------
# host side (numpy)
# ---------------------------------------------------------------------------


def get_directions(n: int) -> np.ndarray:
    """Fixed RBSP direction sets (RBSPShared.h:29-75 getDirections):
    3 = coordinate axes; 7 = + 4 main diagonals; 9 = + 6 edge diagonals;
    13 = all of the above."""
    axes = np.eye(3)
    s3 = 1.0 / np.sqrt(3.0)
    main_diag = np.array([[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1]]) * s3
    s2 = 1.0 / np.sqrt(2.0)
    edge_diag = np.array([[1, 1, 0], [1, -1, 0], [1, 0, 1],
                          [1, 0, -1], [0, 1, 1], [0, 1, -1]]) * s2
    if n <= 3:
        return axes
    if n <= 7:
        return np.concatenate([axes, main_diag])
    if n <= 9:
        return np.concatenate([axes, edge_diag])
    return np.concatenate([axes, main_diag, edge_diag])


def _box_corners(lo, hi):
    corners = np.stack(np.meshgrid(*[[0, 1]] * 3, indexing="ij"),
                       -1).reshape(8, 3)
    return lo[:, None, :] + corners[None] * (hi - lo)[:, None, :]


def scene_prim_points(scene, lo, hi):
    """Representative points + normals per primitive for the BSP-family
    builders: triangle vertices (Triangle::getBounds(Vector3f) projects
    vertices, triangle.cpp:661) and AABB corners for spheres; normals are
    the per-prim geometric normals (Primitive::Normal(), primitive.h:72)."""
    t = scene.triangles
    n_tri = t.count
    n_total = len(lo)
    pts = np.zeros((n_total, 8, 3))
    npts = np.zeros(n_total, np.int32)
    normals = np.zeros((n_total, 3))
    if n_tri:
        pts[:n_tri, 0] = t.p0
        pts[:n_tri, 1] = t.p1
        pts[:n_tri, 2] = t.p2
        npts[:n_tri] = 3
        nrm = np.cross(t.p1 - t.p0, t.p2 - t.p0)
        nl = np.linalg.norm(nrm, axis=-1, keepdims=True)
        normals[:n_tri] = nrm / np.maximum(nl, 1e-20)
    if n_total > n_tri:
        pts[n_tri:] = _box_corners(lo[n_tri:], hi[n_tri:])
        npts[n_tri:] = 8
        normals[n_tri:] = np.array([1.0, 0.0, 0.0])
    return pts, npts, normals


def leaf_mask(flags, n_dirs: int, per_node: bool) -> np.ndarray:
    flags = np.asarray(flags)
    return flags == 1 if per_node else flags >= n_dirs


def tree_depth(is_leaf, above) -> int:
    """Number of levels of the tree (root alone = 1). Nodes are in preorder:
    the below child of interior node i is i + 1, the above child above[i]."""
    is_leaf = np.asarray(is_leaf)
    if not len(is_leaf):
        return 1
    above = np.asarray(above)
    interior = np.flatnonzero(~is_leaf)
    if not (above[interior] > interior).all():
        raise ValueError("kd/BSP nodes are not in preorder")
    depth = 1
    level = np.zeros(1, np.int64)
    while True:
        level = level[~is_leaf[level]]
        if not len(level):
            return depth
        level = np.concatenate([level + 1, above[level].astype(np.int64)])
        depth += 1


def node_rows(flags, split, above, nprims, dirs, ndir=None) -> np.ndarray:
    """One 32-byte row a node, (K, 8) float32, for the CUDA kernel: cols 0-2
    the split direction, col 3 the split offset (float32); col 4 the leaf
    flag, col 5 the above-child id or a leaf's first prim row, col 6 the
    leaf's prim count (int32 bit patterns); col 7 unused. kd / RBSP trees
    carry a direction INDEX in flags, the unrestricted-BSP family a direction
    per node; either way the row holds the direction itself."""
    flags = np.asarray(flags)
    dirs = np.asarray(dirs, np.float32)
    per_node = ndir is not None
    is_leaf = leaf_mask(flags, len(dirs), per_node)
    if per_node:
        nd = np.asarray(ndir, np.float32)
    else:
        nd = dirs[np.minimum(flags, len(dirs) - 1)]
    rows = np.zeros((len(flags), 8), np.float32)
    rows[:, 0:3] = nd
    rows[:, 3] = np.asarray(split, np.float32)
    ints = rows.view(np.int32)
    ints[:, 4] = is_leaf
    ints[:, 5] = np.asarray(above)
    ints[:, 6] = np.asarray(nprims)
    return rows


def pack_kdbsp_nodes(nodes: dict, dirs):
    """(prim_rows4, prim_ids4, above4, tree_depth) from a builder's output.
    The leaf prim runs are re-packed with 4-aligned starts, each run
    padded with copies of its last row, and 16 zero rows (ids -1) end the
    table: the JAX package lays them out so for its TPU kernel's chunked
    copies, and the layout is kept so that the tables of both packages are
    array-equal. Nothing here reads a pad row: a leaf is walked to `nprims`."""
    flags = np.asarray(nodes["flags"])
    above = np.asarray(nodes["above"])
    nprims = np.asarray(nodes["nprims"])
    prim_rows = np.asarray(nodes["prim_rows"], np.float32)
    prim_ids = np.asarray(nodes["prim_ids"])
    ndir = nodes.get("ndir")
    is_leaf = leaf_mask(flags, len(dirs), ndir is not None)

    leaf_idx = np.flatnonzero(is_leaf & (nprims > 0))
    order = leaf_idx[np.argsort(above[leaf_idx], kind="stable")]
    first = above[order].astype(np.int64)
    count = nprims[order].astype(np.int64)
    count4 = count + (-count) % 4
    starts = np.cumsum(count4) - count4
    total = int(count4.sum())
    run = np.repeat(np.arange(len(order)), count4)
    local = np.arange(total) - starts[run]
    src = first[run] + np.minimum(local, count[run] - 1)
    tail = (-total) % 4 + _TAIL_ROWS
    prim_rows4 = np.concatenate(
        [prim_rows[src], np.zeros((tail, prim_rows.shape[1]), np.float32)])
    prim_ids4 = np.concatenate(
        [prim_ids[src], np.full(tail, -1, prim_ids.dtype)])
    starts4 = np.zeros(len(flags), np.int64)
    starts4[order] = starts
    above4 = np.where(is_leaf, starts4, above).astype(np.int32)
    return prim_rows4, prim_ids4, above4, tree_depth(is_leaf, above)


def build_alt_accel(scene, name: str, params=None):
    """MakeAccelerator counterpart for the kd/BSP family (api.cpp:790-1016):
    build the requested tree with the native builders. Returns (nodes, dirs,
    max_leaf, stats): `nodes` a dict of numpy arrays (flags, split, above,
    nprims, prim_ids, prim_rows, and ndir for the unrestricted-BSP family),
    `dirs` the (D,3) float32 direction table. None for BVH names."""
    from tpupt_torch.accel.bvh import scene_prim_bounds
    from tpupt_torch.native import build_bsp, build_kdtree, build_rbsp
    from tpupt_torch.scene.device import pack_prim_rows

    if name in ("bvh", "bvhold", "", None):
        return None
    lo, hi = scene_prim_bounds(scene)
    p = params
    icost = p.find_one_float("intersectcost", 80.0) if p else 80.0
    tcost = p.find_one_float("traversalcost", 1.0) if p else 1.0
    ebonus = p.find_one_float("emptybonus", 0.5) if p else 0.5
    maxp = p.find_one_int("maxprims", 1) if p else 1
    maxd = p.find_one_int("maxdepth", -1) if p else -1

    extra = {}
    if name in ("kdtree", "kdtreeold"):
        out = build_kdtree(lo, hi, icost, tcost, ebonus, maxp, maxd)
        dirs = np.eye(3)
    elif name.startswith("bsp"):
        # unrestricted-BSP family with per-node direction policies
        # (MakeAccelerator names api.cpp:847-1006): bsp{cluster,arbitrary,
        # random}[withkd|fastkd], bsppaper, bsppaperkd
        base = name[3:]
        if base.startswith("paper"):
            policy, kd_mode = "paper", ("fastkd" if base == "paperkd" else "")
        else:
            policy = next((q for q in ("cluster", "arbitrary", "random")
                           if base.startswith(q)), None)
            if policy is None:
                raise ValueError(f"unknown accelerator {name!r}")
            kd_mode = base[len(policy):]
        n_dirs = p.find_one_int("nbDirections", 3) if p else 3
        tcost = p.find_one_float("traversalcost", 5.0) if p else 5.0
        kd_tcost = p.find_one_float("kdtraversalcost", 1.0) if p else 1.0
        ebonus = p.find_one_float("emptybonus", 0.0) if p else 0.0
        pts, npts, normals = scene_prim_points(scene, lo, hi)
        wlo, whi = scene.world_bounds()
        out = build_bsp(pts, npts, normals, wlo, whi, policy=policy,
                        kd_mode=kd_mode, k=n_dirs, isect_cost=icost,
                        traversal_cost=tcost, kd_traversal_cost=kd_tcost,
                        empty_bonus=ebonus, max_prims=maxp, max_depth=maxd)
        dirs = np.eye(3)
        extra = dict(n_kd_nodes=out["n_kd_nodes"],
                     n_bsp_nodes=out["n_bsp_nodes"])
    else:
        # RBSP defaults differ from kd (CreateRBSPTreeAccelerator,
        # rbsp.cpp:551-556): traversalcost 5, emptybonus 0
        n_dirs = p.find_one_int("nbDirections", 3) if p else 3
        tcost = p.find_one_float("traversalcost", 5.0) if p else 5.0
        ebonus = p.find_one_float("emptybonus", 0.0) if p else 0.0
        dirs = get_directions(n_dirs)
        t = scene.triangles
        # per-prim projected bounds along every direction
        # (Triangle::getBounds(Vector3f), triangle.cpp:661)
        if t.count:
            pr0 = t.p0 @ dirs.T
            pr1 = t.p1 @ dirs.T
            pr2 = t.p2 @ dirs.T
            tmin = np.minimum(np.minimum(pr0, pr1), pr2)
            tmax = np.maximum(np.maximum(pr0, pr1), pr2)
        else:
            tmin = np.zeros((0, len(dirs)))
            tmax = np.zeros((0, len(dirs)))
        if scene.spheres.count:
            # sphere projected bounds from AABB corners (conservative)
            proj = _box_corners(lo[t.count:], hi[t.count:]) @ dirs.T
            tmin = np.concatenate([tmin, proj.min(1)])
            tmax = np.concatenate([tmax, proj.max(1)])
        wlo, whi = scene.world_bounds()
        out = build_rbsp(dirs, tmin, tmax, wlo, whi, icost, tcost, ebonus,
                         maxp, maxd)

    per_node = "ndir" in out
    dirs = dirs.astype(np.float32)
    raw = dict(flags=out["flags"], split=out["split"], above=out["above"],
               nprims=out["nprims"], prim_ids=out["prim_ids"],
               prim_rows=pack_prim_rows(scene, out["prim_ids"]))
    if per_node:
        raw["ndir"] = out["ndir"]
    prim_rows4, prim_ids4, above4, depth = pack_kdbsp_nodes(raw, dirs)
    nodes = dict(raw, above=above4, prim_ids=prim_ids4, prim_rows=prim_rows4)
    max_leaf = int(out["nprims"].max()) if len(out["nprims"]) else 1
    stats = dict(
        n_nodes=out["n_nodes"], build_seconds=out["build_seconds"],
        max_leaf=max_leaf,
        n_leaves=int(leaf_mask(out["flags"], len(dirs), per_node).sum()),
        **extra, tree_depth=depth)
    return nodes, dirs, max_leaf, stats


def alt_tables(nodes: dict, dirs):
    """(alt_* fields of DeviceScene as numpy arrays, alt_* statics) from a
    node dict as `build_alt_accel` returns it, of this package or of the JAX
    package (whose float-coded node tiles are not read): the prim rows, and
    the node rows packed from the flat arrays."""
    flags = np.asarray(nodes["flags"])
    above = np.asarray(nodes["above"])
    nprims = np.asarray(nodes["nprims"])
    dirs = np.asarray(dirs, np.float32)
    ndir = nodes.get("ndir")
    fields = dict(
        alt_prim_rows=np.asarray(nodes["prim_rows"], np.float32),
        alt_nodes=node_rows(flags, nodes["split"], above, nprims, dirs, ndir))
    statics = dict(
        alt_max_leaf=max(int(nprims.max()) if len(nprims) else 1, 1),
        alt_tree_depth=tree_depth(
            leaf_mask(flags, len(dirs), ndir is not None), above))
    return fields, statics


def node_type_depth_maps(nodes, dirs):
    """Node-type depth histograms (GenericBSP::writeNodeTypeDepthMaps,
    genericBSP.h:132-152): {kd,bsp,leaf}NodeDepths as {depth: count}.
    KD = axis-aligned split direction, BSP = arbitrary direction."""
    flags = np.asarray(nodes["flags"])
    above = np.asarray(nodes["above"])
    per_node = "ndir" in nodes
    is_leaf = leaf_mask(flags, np.asarray(dirs).shape[0], per_node)
    if per_node:
        axis_aligned = (np.abs(np.asarray(nodes["ndir"])) > 1 - 1e-6).any(-1)
    else:
        axis_aligned = flags < 3  # first 3 table entries are the axes
    maps = {"kdNodeDepths": {}, "bspNodeDepths": {}, "leafNodeDepths": {}}
    if not len(flags):
        return maps
    stack = [(0, 0)]
    while stack:
        node, depth = stack.pop()
        if is_leaf[node]:
            m = maps["leafNodeDepths"]
        elif axis_aligned[node]:
            m = maps["kdNodeDepths"]
        else:
            m = maps["bspNodeDepths"]
        m[depth] = m.get(depth, 0) + 1
        if not is_leaf[node]:
            stack.append((node + 1, depth + 1))
            stack.append((int(above[node]), depth + 1))
    return maps


def dump_tree(nodes, dirs, path):
    """Full-tree text serialization (GenericBSP::operator<<,
    genericBSP.h:107-130: direction count + directions, node count + nodes,
    then per-leaf prim ids). Off by default in the reference too
    (writeFile=false, api.cpp:794)."""
    flags = np.asarray(nodes["flags"])
    split = np.asarray(nodes["split"])
    above = np.asarray(nodes["above"])
    nprims = np.asarray(nodes["nprims"])
    prim_ids = np.asarray(nodes["prim_ids"])
    per_node = "ndir" in nodes
    d = np.asarray(dirs)
    is_leaf = leaf_mask(flags, len(d), per_node)
    nd = np.asarray(nodes["ndir"]) if per_node else None
    with open(path, "w") as f:
        f.write(f"{len(d)}\n")
        for row in d:
            f.write(f"{row[0]} {row[1]} {row[2]}\n")
        f.write(f"{len(flags)}\n")
        for i in range(len(flags)):
            if is_leaf[i]:
                ids = prim_ids[above[i]: above[i] + nprims[i]]
                f.write("L " + " ".join(str(int(x)) for x in ids) + "\n")
            elif per_node:
                f.write(f"B {nd[i][0]} {nd[i][1]} {nd[i][2]} "
                        f"{split[i]} {above[i]}\n")
            else:
                f.write(f"I {flags[i]} {split[i]} {above[i]}\n")


# ---------------------------------------------------------------------------
# tensor side: the plain PyTorch walker
# ---------------------------------------------------------------------------


def check_tree(st) -> None:
    """Raise unless the statics describe a kd / RBSP / BSP tree that the
    walker's and the kernel's stack of KD_STACK entries can walk."""
    if st.alt_tree_depth == 0:
        raise ValueError("the scene was uploaded without kd/BSP tables")
    if st.alt_tree_depth + 1 > KD_STACK:
        raise ValueError(
            f"a tree of {st.alt_tree_depth} levels is too deep for the "
            f"traversal stack of {KD_STACK} entries")


def _project(v, nd):
    """dot(v, nd) term by term, left to right: a library product may fuse or
    reorder the sum, and the CUDA kernel repeats exactly this order."""
    return v[:, 0] * nd[:, 0] + v[:, 1] * nd[:, 1] + v[:, 2] * nd[:, 2]


def _alive(have, sp, peak) -> bool:
    """Whether any ray still has a node in hand or on its stack; raises when
    a push went past the stack's capacity (`peak`: the deepest so far)."""
    if int(peak) > KD_STACK:
        raise RuntimeError(
            f"kd/BSP stack overflow: depth {int(peak)} > {KD_STACK}")
    return bool((have | (sp > 0)).any())


@torch.no_grad()
def intersect_kdbsp(ds, st, o, d, tmax, any_hit: bool = False, touched=None):
    """Closest hit (or, with any_hit, the first occluder found) of each ray
    through the kd / RBSP / BSP tree in the `alt_*` tables of `ds`.

    pbrt's recursion unrolled (kdtreeaccel.cpp:410-532), all rays in
    lockstep: each ray holds a node and the interval [tmin, tmax] of its
    cell, goes to the child on its own side of the split plane first and
    pushes the other with its interval when the plane lies inside the cell,
    and stops when a hit lies inside the cell it was found in. The batch
    alternates between two phases, every ray walking down to its next leaf
    and then every ray testing its leaf's prims, so that a fat kd leaf
    (hundreds of prims) costs one pass over its prims a round and not one a
    step; what a ray computes does not depend on the phases. Counters: one node visit per interior node, one leaf visit per leaf,
    one prim test per prim of a visited leaf. Lanes with tmax == 0 (dead lanes
    of the wavefront) and rays that miss the world bounds never enter the
    loop. `touched` = (node mask (K,), prim-row mask (P,)) bool tensors, when
    given, get True at every row some ray read. Returns (Hit,
    TraversalStats)."""
    check_tree(st)
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    perm = ray_permutation(d)
    inv_d = ray_inv_d(d)
    prim_ints = ds.alt_prim_rows[:, 16:18].view(i32)
    # a node row: direction xyz, split | leaf flag, above / first prim, nprims
    node_ints = ds.alt_nodes[:, 4:7].view(i32)

    t_cur = tmax.to(torch.float32).clone()
    # clip to the world bounds for the root's interval
    t_lo = (ds.world_lo - o) * inv_d
    t_hi = (ds.world_hi - o) * inv_d
    tmin = torch.amax(torch.minimum(t_lo, t_hi), dim=-1).clamp_min(0.0)
    tmaxn = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), dim=-1), t_cur)
    have = (t_cur > 0.0) & ~(tmin > tmaxn)
    node = torch.zeros(n, dtype=torch.int64, device=dev)

    # column KD_STACK absorbs the writes of lanes that push nothing
    snode = torch.zeros((n, KD_STACK + 1), dtype=torch.int64, device=dev)
    stmin = torch.zeros((n, KD_STACK + 1), device=dev)
    stmax = torch.zeros((n, KD_STACK + 1), device=dev)
    sp = torch.zeros(n, dtype=i32, device=dev)
    rec = [t_cur, torch.full((n,), -1, dtype=i32, device=dev),
           torch.zeros(n, dtype=torch.int64, device=dev),
           torch.zeros(n, device=dev), torch.zeros(n, device=dev),
           torch.zeros(n, dtype=i32, device=dev)]
    nodes_v = torch.zeros(n, dtype=i32, device=dev)
    leaves_v = torch.zeros(n, dtype=i32, device=dev)

    peak = torch.zeros((), dtype=i32, device=dev)   # deepest stack so far
    while _alive(have, sp, peak):
        # ---------- every lane walks down to its next leaf -----------------
        while True:
            # lanes without a node take the top of their stack
            need = ~have & (sp > 0)
            # (a stack past its capacity reads the spare column until
            # `_alive` raises)
            top = (sp - 1).clamp(0, KD_STACK).long()[:, None]
            node = torch.where(need, snode.gather(1, top)[:, 0], node)
            tmin = torch.where(need, stmin.gather(1, top)[:, 0], tmin)
            tmaxn = torch.where(need, stmax.gather(1, top)[:, 0], tmaxn)
            sp = torch.where(need, sp - 1, sp)
            # a hit closer than the cell's entry: drop the cell
            have = (have | need) & ~(rec[0] < tmin)

            is_leaf = node_ints[node, 0] != 0
            act_int = have & ~is_leaf
            # done when every lane holds a leaf or has nothing left
            if not bool((act_int | (~have & (sp > 0))).any()):
                break
            nodes_v = nodes_v + act_int.to(i32)
            if touched is not None:
                touched[0][node[act_int]] = True

            # projected plane distance (rbsp.cpp:68-80)
            row = ds.alt_nodes[node]
            op = _project(o, row)
            dp = _project(d, row)
            split = row[:, 3]
            t_plane = (split - op) / torch.where(dp.abs() < 1e-12, 1e-12, dp)
            below_first = (op < split) | ((op == split) & (dp <= 0.0))
            below = node + 1
            abv = node_ints[node, 1].long()
            first_child = torch.where(below_first, below, abv)
            second_child = torch.where(below_first, abv, below)
            # which children to visit (kdtreeaccel.cpp:430-450); pbrt's
            # if / elif: only_first has priority (both can hold when
            # t_plane <= 0)
            only_first = (t_plane > tmaxn) | (t_plane <= 0.0)
            only_second = (t_plane < tmin) & ~only_first
            both = act_int & ~only_first & ~only_second
            slot = torch.where(both, sp, KD_STACK).clamp_max(KD_STACK)
            slot = slot.long()[:, None]
            snode.scatter_(1, slot, second_child[:, None])
            stmin.scatter_(1, slot, t_plane[:, None])
            stmax.scatter_(1, slot, tmaxn[:, None])
            sp = sp + both.to(i32)
            peak = torch.maximum(peak, sp.max())
            node = torch.where(
                act_int, torch.where(only_second, second_child, first_child),
                node)
            tmaxn = torch.where(both, t_plane, tmaxn)

        # ---------- every lane that holds a leaf tests its `nprims` prims ---
        leaves_v = leaves_v + have.to(i32)
        if touched is not None:
            touched[0][node[have]] = True
        rec = _leaf_step(ds.alt_prim_rows, prim_ints, st, have,
                         node_ints[node, 1].long(), node_ints[node, 2], o, d,
                         perm, rec, None if touched is None else touched[1],
                         max_leaf=st.alt_max_leaf)
        # a hit inside the leaf's cell ends the walk
        sp = torch.where(have & (rec[0] <= tmaxn), 0, sp)
        if any_hit:
            sp = torch.where(rec[1] >= 0, 0, sp)
        have = torch.zeros_like(have)

    t_cur, gid, ridx, b1, b2, tests = rec
    p_obj = quadric_hit_point(ds.alt_prim_rows, st, o, d, t_cur, ridx)
    hit = Hit(valid=gid >= 0, t=t_cur, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, TraversalStats(nodes_v, leaves_v, tests)
