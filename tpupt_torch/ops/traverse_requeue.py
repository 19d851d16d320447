"""Wrappers of the two CUDA kernels of the re-queue traversal
(csrc/traverse_requeue.cu) and its driver `intersect_requeue`.

The re-queue traversal is the two-level traversal regrouped by treelet, the
JAX package's answer for incoherent bounce rays over large scenes
(tpupt/ops/traverse_requeue.py `intersect_packets_requeue`):

1. `bin_rays_cuda` walks each ray through the top tree and lists up to
   `r_list` treelets it enters, with their entry t (kernel `bin_rays`);
2. the driver sorts each list by entry t, builds a key treelet * 8 +
   direction octant for each live (ray, treelet) pair and sorts the pairs
   by it, so that neighbouring threads walk the same treelet;
3. `walk_pairs_cuda` walks each pair, one thread a pair, from the ray's best
   t when the pass starts (kernel `walk_pairs`); a ray takes the smallest t
   of its pairs, among equal t the first pair in sorted order, and a later
   pass replaces a hit only with a strictly smaller t. Pass 0 walks each
   ray's nearest `wave0` treelets, pass 1 every other pair whose entry t is
   below the ray's best t by then;
4. a ray whose list overflowed (and, for any hit, is still unoccluded)
   takes its whole hit from the two-level kernel (ops/traverse_treelets.py),
   which is launched with tmax 0 on every other ray; its counters stay
   those of the pairs walked before.

The JAX package runs a third pass for pairs that a 1024-lane chunk had to
defer (at most 16 treelets a chunk). One thread a pair defers nothing, so
there are two passes here and `TraversalStats.truncated` is zero. Counters
are summed per ray over the pairs it walked (the JAX package takes, per
pass, the largest of its chunks' packet counters). The driver's own work is
plain PyTorch on the rays' device, as it is plain XLA there, and asks the
host nothing: a call on the card queues its launches and returns.

For tensors on a CUDA device the wrappers launch their kernels, built at
first use with nvcc into the git-ignored build directory, or raise. For
tensors on the CPU they call the plain versions `accel.traverse.bin_rays` /
`walk_pairs`, which are also what the kernels are held against on the card.

`launches` counts each kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops.traverse_treelets import intersect_treelets_cuda
from tpupt_torch.ops.traverse_wide import (_check, alloc_outputs, check_rays,
                                           check_table, raise_on_overflow)
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "traverse_requeue"
R_LIST = trav.R_LIST   # treelet records a ray keeps
WAVE0 = 2              # nearest treelets walked in pass 0

# kernel launches since import (or since a caller zeroed them)
launches = {"bin_rays": 0, "walk_pairs": 0}

_LOCK = threading.Lock()
_LIB = None
_OVERFLOW = {}  # device index -> one-int tensor the kernels report overflow in


def build(extra_flags=(), out: str = None):
    """Compile both kernels into one shared library. Returns (path, what
    nvcc printed); see utils.build.build_cuda."""
    return build_cuda(NAME, extra_flags, out)


def load(path: str):
    """ctypes handle of a library made by `build`, with argtypes set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_bin_rays.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp]
    lib.tpupt_bin_rays.restype = ci
    lib.tpupt_walk_pairs.argtypes = (
        [vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci] + [vp] * 9
        + [ci, ci, ci, vp])
    lib.tpupt_walk_pairs.restype = ci
    return lib


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if cuda_is_stale(NAME):
                build()
            _LIB = load(cuda_library(NAME))
        return _LIB


def check_stack_depth():
    """Synchronise and raise if a ray or pair of either kernel needed a
    deeper stack than WIDE_STACK since the last check."""
    raise_on_overflow(_OVERFLOW, "re-queue", trav.WIDE_STACK)


def _overflow_int(dev):
    deepest = _OVERFLOW.get(dev.index)
    if deepest is None:
        deepest = _OVERFLOW[dev.index] = torch.zeros(1, dtype=torch.int32,
                                                     device=dev)
    return deepest


def _require_two_level(st):
    if not st.two_level:
        raise ValueError("the scene was uploaded without two-level tables")


def bin_rays_cuda(ds, st, o, d, tmax, r_list: int = R_LIST, lib=None):
    """(tid (N, r_list) i32, tnear (N, r_list) f32, ovf (N,) i32) of rays o,
    d (N,3) float32, tmax (N,) float32, all contiguous on one device: each
    ray's treelets in top-tree walk order (see accel.traverse.bin_rays).

    CUDA tensors: launches kernel `bin_rays` on the current stream (no
    synchronise) or raises. CPU tensors: the plain `bin_rays`. `lib`
    overrides the loaded library (used to time other builds)."""
    _require_two_level(st)
    if r_list < 1:
        raise ValueError(f"r_list must be at least 1, got {r_list}")
    dev, n = check_rays(o, d, tmax)
    check_table("ds.top_nodes", ds.top_nodes, 64, torch.float32, dev)
    if dev.type == "cpu":
        return trav.bin_rays(ds, st, o, d, tmax, r_list)

    lib = lib or get_lib()
    tid = torch.empty((n, r_list), dtype=torch.int32, device=dev)
    tnear = torch.empty((n, r_list), dtype=torch.float32, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    deepest = _overflow_int(dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_bin_rays(
                ds.top_nodes.data_ptr(), o.data_ptr(), d.data_ptr(),
                tmax.data_ptr(), n, r_list, tid.data_ptr(), tnear.data_ptr(),
                ovf.data_ptr(), deepest.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bin_rays kernel launch failed: CUDA error {rc}")
        launches["bin_rays"] += 1
    return tid, tnear, ovf


def walk_pairs_cuda(ds, st, o, d, key, ray, t_in, any_hit: bool = False,
                    with_stats: bool = True, lib=None) -> trav.PairRecords:
    """PairRecords of the (ray, treelet) pairs `key` / `ray` (P,) int32 for
    rays o, d (N,3) float32 starting from t_in (N,) float32, all contiguous
    on one device (see accel.traverse.walk_pairs).

    CUDA tensors: launches kernel `walk_pairs` on the current stream (no
    synchronise) or raises. CPU tensors: the plain `walk_pairs`.
    with_stats=False leaves the counters out of the kernel and returns zeros
    for them. `lib` overrides the loaded library."""
    _require_two_level(st)
    dev, _ = check_rays(o, d, t_in)
    p = key.shape[0] if key.dim() == 1 else -1
    _check("key", key, (p,), torch.int32, dev)
    _check("ray", ray, (p,), torch.int32, dev)
    check_table("ds.tl_nodes", ds.tl_nodes, 64, torch.float32, dev)
    check_table("ds.tl_prims", ds.tl_prims, 32, torch.float32, dev)
    check_table("ds.tl_offsets", ds.tl_offsets, 2, torch.int32, dev)
    if dev.type == "cpu":
        return trav.walk_pairs(ds, st, o, d, key, ray, t_in, any_hit=any_hit)

    lib = lib or get_lib()
    outs, deepest, stat_ptrs = alloc_outputs(p, dev, with_stats, _OVERFLOW)
    t, b1, b2, gid, ridx, nodes, leaves, tests = outs
    if p > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_walk_pairs(
                ds.tl_nodes.data_ptr(), ds.tl_prims.data_ptr(),
                ds.tl_prims.shape[0], ds.tl_offsets.data_ptr(),
                o.data_ptr(), d.data_ptr(), key.data_ptr(), ray.data_ptr(),
                t_in.data_ptr(), p, trav.pair_sentinel(st), t.data_ptr(),
                b1.data_ptr(), b2.data_ptr(), gid.data_ptr(), ridx.data_ptr(),
                *stat_ptrs, deepest.data_ptr(), int(any_hit),
                int(st.n_spheres > 0), int(with_stats), stream)
        if rc != 0:
            raise RuntimeError(
                f"walk_pairs kernel launch failed: CUDA error {rc}")
        launches["walk_pairs"] += 1
    return trav.PairRecords(t, gid, ridx, b1, b2, nodes, leaves, tests)


def _octants(d):
    """Direction octant of each ray, 0..7: the second sort key of a pair, so
    that the rays of a warp that walk one treelet also head one way."""
    i32 = torch.int32
    return ((d[:, 0] < 0).to(i32) + 2 * (d[:, 1] < 0).to(i32)
            + 4 * (d[:, 2] < 0).to(i32))


def _initial_best(tmax):
    """Each ray's best (t, gid, ridx, b1, b2) before the first pass."""
    n, dev = tmax.shape[0], tmax.device
    return (tmax.clone(), torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), torch.zeros(n, device=dev))


def _sorted_lists(tid, tnear):
    """Each ray's list nearest first; empty records (tnear 3e38) stay last
    and equal entry t keep their walk order."""
    tnear, order = torch.sort(tnear, dim=1, stable=True)
    return tid.gather(1, order), tnear


def _pass_pairs(st, tid, tnear, octant, t_best, gid, walked, slot_limit,
                any_hit: bool):
    """The pairs of one pass: every unwalked (ray, slot < slot_limit) record
    with a treelet whose entry t is below the ray's best t (for any hit only
    on rays still unoccluded). Returns (key, ray, live): key (N * R,) i32
    sorted by treelet * 8 + octant (the rest carry the sentinel and come
    last), ray (N * R,) i32 each sorted pair's ray, live (N, R) bool."""
    n, r_list = tid.shape
    slot = torch.arange(r_list, device=tid.device)
    live = (~walked) & (tid >= 0) & (tnear < t_best[:, None]) \
        & (slot < slot_limit)
    if any_hit:
        live = live & (gid < 0)[:, None]
    key = torch.where(live, tid * 8 + octant[:, None],
                      trav.pair_sentinel(st)).reshape(-1)
    key, perm = torch.sort(key, stable=True)
    return key, (perm // r_list).to(torch.int32), live


def _combine(rec: trav.PairRecords, ray, best):
    """Each ray's winner among its pairs of this pass: the smallest t, and
    among exactly that t the first pair in sorted order; it replaces the
    ray's best (t, gid, ridx, b1, b2) only where its t is strictly smaller.
    Returns the new best."""
    t_best, gid, ridx, b1, b2 = best
    n, p = t_best.shape[0], rec.t.shape[0]
    ray = ray.long()
    hit = rec.gid >= 0
    win_t = torch.full((n,), float("inf"), device=t_best.device).scatter_reduce(
        0, ray, torch.where(hit, rec.t, float("inf")), "amin")
    improve = win_t < t_best
    is_win = hit & (rec.t == win_t[ray]) & improve[ray]
    pair = torch.arange(p, device=ray.device)
    w = torch.full((n,), p, dtype=torch.int64, device=ray.device).scatter_reduce(
        0, ray, torch.where(is_win, pair, p), "amin").clamp_max(p - 1)
    return (torch.where(improve, win_t, t_best),
            torch.where(improve, rec.gid[w], gid),
            torch.where(improve, rec.ridx[w], ridx),
            torch.where(improve, rec.b1[w], b1),
            torch.where(improve, rec.b2[w], b2))


def intersect_requeue(ds, st, o, d, tmax, any_hit: bool = False,
                      with_stats: bool = True, r_list: int = R_LIST,
                      wave0: int = WAVE0):
    """(Hit, TraversalStats) of rays o, d (N,3) float32, tmax (N,) float32,
    all contiguous on one device, against the two-level tables of `ds`,
    through the re-queue traversal: the same contract as
    `intersect_treelets_cuda`, usable as `Renderer(..., isect=...)`. With
    any_hit a hit's t is 0, as in the JAX package."""
    _require_two_level(st)
    if not 1 <= wave0 <= r_list:
        raise ValueError(f"wave0 must lie in 1..r_list, got {wave0}")
    check_rays(o, d, tmax)
    return _requeue(
        bin_rays_cuda, functools.partial(walk_pairs_cuda, with_stats=with_stats),
        functools.partial(intersect_treelets_cuda, with_stats=False),
        ds, st, o, d, tmax, any_hit, with_stats, r_list, wave0)


def _requeue(bin_fn, walk, fallback, ds, st, o, d, tmax, any_hit: bool = False,
             with_stats: bool = True, r_list: int = R_LIST,
             wave0: int = WAVE0):
    """The re-queue traversal's passes over three functions with the
    signatures of `bin_rays_cuda(ds, st, o, d, tmax, r_list)`,
    `walk_pairs_cuda(ds, st, o, d, key, ray, t_in, any_hit=)` and
    `intersect_treelets_cuda(ds, st, o, d, tmax, any_hit=)`:
    `intersect_requeue` passes the kernels' wrappers; given the plain
    versions it is the same traversal without a kernel."""
    dev, n = tmax.device, tmax.shape[0]
    i32 = torch.int32
    tid, tnear, ovf = bin_fn(ds, st, o, d, tmax, r_list)
    tid, tnear = _sorted_lists(tid, tnear)
    octant = _octants(d)
    best = _initial_best(tmax)
    counters = [torch.zeros(n, dtype=i32, device=dev) for _ in range(3)]
    walked = torch.zeros(tid.shape, dtype=torch.bool, device=dev)
    for slot_limit in (wave0, r_list):
        key, ray, live = _pass_pairs(st, tid, tnear, octant, best[0], best[1],
                                     walked, slot_limit, any_hit)
        rec = walk(ds, st, o, d, key, ray, best[0], any_hit=any_hit)
        best = _combine(rec, ray, best)
        if with_stats:
            for acc, c in zip(counters, rec[5:]):
                acc.index_add_(0, ray, c)
        walked = walked | live
    t_best, gid, ridx, b1, b2 = best

    # pairs still live after the last pass: none by construction (every
    # live pair of pass 1 is walked), counted as the JAX package counts them
    rem = ((~walked) & (tid >= 0) & (tnear < t_best[:, None])).sum(1).to(i32)
    if any_hit:
        rem = torch.where(gid >= 0, 0, rem)

    # ---- exact fallback for rays whose list overflowed ----
    need_fb = ovf > 0
    if any_hit:
        need_fb = need_fb & (gid < 0)
    hit_fb, _ = fallback(ds, st, o, d, torch.where(need_fb, tmax, 0.0),
                         any_hit=any_hit)
    t = torch.where(need_fb, hit_fb.t, t_best)
    gid = torch.where(need_fb, hit_fb.prim, gid)
    b1 = torch.where(need_fb, hit_fb.b1, b1)
    b2 = torch.where(need_fb, hit_fb.b2, b2)
    p_obj = torch.where(need_fb[:, None], hit_fb.p_obj,
                        trav.quadric_hit_point(ds.tl_prims, st, o, d, t_best,
                                               ridx))
    if any_hit:
        t = torch.where(gid >= 0, 0.0, t)
    hit = trav.Hit(valid=gid >= 0, t=t, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, trav.TraversalStats(*counters,
                                    truncated=torch.where(need_fb, 0, rem))
