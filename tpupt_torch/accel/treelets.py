"""Two-level partition of the wide BVH: a top tree whose leaves are treelet
references, and treelets, each a subtree stored as one contiguous run of node
rows followed (in a second table) by one contiguous run of its prim rows.

The cut rule is the JAX package's (`tpupt.accel.treelets.build_treelets`), so
that a scene is cut into the same treelets by both packages: walking down from
the root, an interior child becomes a treelet root as soon as its subtree holds
at most `tn` node rows and `tp - 64` prim rows (leaf runs counted in multiples
of 4, as that package pads them); a prim-leaf slot of a top node becomes a
treelet of one node. The LAYOUT is not carried over: that package pads every
treelet to `tn` x 128 and `tp` x 32 floats and float-codes the metadata for
its block copies into on-chip memory. Here the blocks are packed end to end at
their true sizes with the single-level row formats, and a small offset table
says where each treelet starts, so the two-level tables take the room of the
single-level ones.

Row formats (see bvh.collapse_to_wide, device.pack_prim_rows):
  top_nodes (Ntop, 64) f32: bounds in cols 0-47, int32 meta bit-cast in cols
      48-55: meta >= 0 top child id; META_EMPTY empty; else a treelet
      reference -(tid) - 1.
  tl_nodes (sum of treelet node counts, 64) f32: the same rows with
      treelet-local child ids and leaf metas -(first * 64 + count) - 1 whose
      `first` counts from the treelet's first prim row.
  tl_prims (P, 32) f32: prim rows in treelet order.
  tl_offsets (NT, 2) i32: first node row and first prim row of each treelet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tpupt_torch.accel.bvh import META_EMPTY

TREELET_NODES = 512    # most node rows in a treelet
TREELET_PRIMS = 4096   # most prim rows in a treelet (64 of them kept spare)


@dataclass
class TreeletArrays:
    top_nodes: np.ndarray
    tl_nodes: np.ndarray
    tl_prims: np.ndarray
    tl_offsets: np.ndarray
    n_treelets: int
    tn: int
    tp: int


def _decode_meta(wide_nodes: np.ndarray):
    meta = np.ascontiguousarray(wide_nodes[:, 48:56]).view(np.int32)
    is_int = meta >= 0
    is_leaf = (~is_int) & (meta != META_EMPTY)
    v = np.where(is_leaf, -meta - 1, 0)
    return meta, is_int, is_leaf, (v >> 6), (v & 63)


def _subtree_sizes(meta, is_int, leaf_count):
    """Per wide node: (node rows, prim rows) of its subtree. Children have
    larger ids than their parents (collapse_to_wide numbers nodes as it
    discovers them), so one sweep from the end suffices."""
    sub_nodes = np.ones(len(meta), np.int64)
    sub_prims = ((leaf_count + 3) & ~3).sum(1).astype(np.int64)
    for i in range(len(meta) - 1, -1, -1):
        kids = meta[i][is_int[i]]
        if kids.size:
            sub_nodes[i] += sub_nodes[kids].sum()
            sub_prims[i] += sub_prims[kids].sum()
    return sub_nodes, sub_prims


def build_treelets(wide_nodes: np.ndarray, prim_rows: np.ndarray,
                   tn: int = TREELET_NODES,
                   tp: int = TREELET_PRIMS) -> TreeletArrays:
    """Cut the wide BVH (collapse_to_wide rows + packed prim rows) into a top
    tree and treelets. Raises ValueError when the whole tree fits one
    treelet: such a scene takes the single-level tables."""
    assert tp >= 128 and tn >= 1
    meta, is_int, is_leaf, leaf_first, leaf_count = _decode_meta(wide_nodes)
    sub_nodes, sub_prims = _subtree_sizes(meta, is_int, leaf_count)
    fits = (sub_nodes <= tn) & (sub_prims <= tp - 64)
    if fits[0]:
        raise ValueError("scene fits a single treelet; use the single-level "
                         "tables instead")

    # ---- top tree (breadth first) and the treelet roots below it ----
    top_ids, top_remap = [], {}
    treelets = []   # ("sub", wide root id) | ("leaf", wide id, slot)
    slot_tl = {}    # (wide id, slot) -> treelet id
    queue = [0]
    for i in queue:            # grows while it is walked
        top_remap[i] = len(top_ids)
        top_ids.append(i)
        for c in range(8):
            if is_int[i, c]:
                ch = int(meta[i, c])
                if fits[ch]:
                    slot_tl[(i, c)] = len(treelets)
                    treelets.append(("sub", ch))
                else:
                    queue.append(ch)
            elif is_leaf[i, c]:
                slot_tl[(i, c)] = len(treelets)
                treelets.append(("leaf", i, c))

    top_nodes = wide_nodes[top_ids].copy()
    top_meta = np.full((len(top_ids), 8), META_EMPTY, np.int32)
    for new_i, i in enumerate(top_ids):
        for c in range(8):
            if (i, c) in slot_tl:
                top_meta[new_i, c] = -slot_tl[(i, c)] - 1
            elif is_int[i, c]:
                top_meta[new_i, c] = top_remap[int(meta[i, c])]
    top_nodes[:, 48:56] = top_meta.view(np.float32)

    # ---- treelets: node rows and prim runs in treelet order ----
    src_node = []        # wide node id behind each treelet node row
    new_meta = []        # its 8 metas, treelet-local
    run_first, run_count = [], []   # prim runs of prim_rows, in output order
    offsets = np.zeros((len(treelets), 2), np.int32)
    n_prims_out = 0
    for tid, spec in enumerate(treelets):
        offsets[tid] = (len(src_node), n_prims_out)
        if spec[0] == "leaf":
            _, i, c = spec
            count = int(leaf_count[i, c])
            m = np.full(8, META_EMPTY, np.int32)
            m[0] = -count - 1            # first = 0
            src_node.append(-(i * 8 + c) - 1)   # marks a one-slot row
            new_meta.append(m)
            run_first.append(int(leaf_first[i, c]))
            run_count.append(count)
            n_prims_out += count
            continue
        order = [spec[1]]
        local = {spec[1]: 0}
        for i in order:        # breadth first, grows while it is walked
            for c in range(8):
                if is_int[i, c]:
                    ch = int(meta[i, c])
                    local[ch] = len(order)
                    order.append(ch)
        assert len(order) <= tn
        pcur = 0
        for i in order:
            m = np.full(8, META_EMPTY, np.int32)
            for c in range(8):
                if is_int[i, c]:
                    m[c] = local[int(meta[i, c])]
                elif is_leaf[i, c]:
                    count = int(leaf_count[i, c])
                    m[c] = -(pcur * 64 + count) - 1
                    run_first.append(int(leaf_first[i, c]))
                    run_count.append(count)
                    pcur += count
            src_node.append(i)
            new_meta.append(m)
        n_prims_out += pcur

    src_node = np.asarray(src_node, np.int64)
    single = src_node < 0
    tl_nodes = wide_nodes[np.where(single, 0, src_node)].copy()
    if single.any():
        # a one-slot row: the leaf slot's bounds in child 0, the rest empty
        code = -src_node[single] - 1
        wi, c = code // 8, code % 8
        rows = np.zeros((len(code), 64), np.float32)
        rows[:, 6:48] = np.tile(
            np.array([np.inf] * 3 + [-np.inf] * 3, np.float32), 7)
        rows[:, 0:6] = wide_nodes[wi[:, None], c[:, None] * 6 + np.arange(6)]
        tl_nodes[single] = rows
    tl_nodes[:, 48:56] = np.stack(new_meta).view(np.float32)

    run_first = np.asarray(run_first, np.int64)
    run_count = np.asarray(run_count, np.int64)
    starts = np.cumsum(run_count) - run_count
    perm = (np.repeat(run_first - starts, run_count)
            + np.arange(int(run_count.sum())))
    tl_prims = prim_rows[perm]
    if len(tl_prims) == 0:
        tl_prims = np.zeros((1, 32), np.float32)

    return TreeletArrays(top_nodes=top_nodes, tl_nodes=tl_nodes,
                         tl_prims=tl_prims, tl_offsets=offsets,
                         n_treelets=len(treelets), tn=tn, tp=tp)
