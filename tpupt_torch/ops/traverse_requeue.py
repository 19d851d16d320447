"""Wrappers of the two CUDA kernels of the re-queue traversal
(csrc/traverse_requeue.cu) and its driver `intersect_requeue`.

The re-queue traversal is the two-level traversal regrouped by treelet, the
JAX package's answer for incoherent bounce rays over large scenes
(tpupt/ops/traverse_requeue.py `intersect_packets_requeue`):

1. `bin_rays_cuda` walks each ray through the top tree and lists up to
   `r_list` treelets it enters, with their entry t, ordered by (entry t,
   walk order) (kernel `bin_rays`);
2. the driver builds a key treelet * 8 + direction octant for each live
   (ray, treelet) pair and sorts the pairs by it (stably, live pairs
   first), so that neighbouring threads walk the same treelet, and counts
   the live pairs on the card (`work`, the count and the kernel's zeroed
   work counter);
3. `walk_pairs_cuda` walks each live pair, one lane a pair (persistent
   warps take the pairs in sorted order), from the ray's best t when the
   pass starts (kernel `walk_pairs`), and picks each
   ray's winner itself: one 64-bit word a ray, (bits of t) << 32 | slot,
   lowered by an atomic min, so that a ray takes the smallest t of its
   pairs, among equal t the first pair in sorted order, and a later pass
   replaces a hit only with a strictly smaller t (`accel.traverse.RayBest`);
   it adds each pair's counters to its ray's. Pass 0 walks each ray's
   nearest `wave0` treelets, the list columns [0, wave0), pass 1 the pairs
   of the columns [wave0, r_list) whose entry t is below the ray's best t
   by then; between the passes the driver reads t (and, for any hit,
   whether there is a hit) back from the words;
4. a ray whose list overflowed (and, for any hit, is still unoccluded)
   takes its whole hit from the two-level kernel (ops/traverse_treelets.py),
   which is launched with tmax 0 on every other ray; its counters stay
   those of the pairs walked before.

Each pass builds and sorts only the keys of its own columns: N * wave0
in pass 0, N * (r_list - wave0) in pass 1. A ray lists each treelet once
(each treelet has one reference in the top tree), so no two of its pairs
share a key, and a stable sort puts the live pairs of a pass in (key, ray)
order whatever columns they came from: in the same order, at the same
slots pass * N * r_list + sorted index, as a sort of all N * r_list slots
of the lists would.

The JAX package runs a third pass for pairs that a 1024-lane chunk had to
defer (at most 16 treelets a chunk). A lane a pair defers nothing, so
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
from tpupt_torch.ops.traverse_wide import (_check, check_rays, check_table,
                                           raise_on_overflow)
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
        [vp, vp, ci] + [vp] * 7 + [ci, ci] + [vp] * 6
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
    d (N,3) float32, tmax (N,) float32, all contiguous on one device: the
    first r_list treelets of each ray's top-tree walk (the rest only
    counted in ovf), ordered by (entry t, walk order), empty records last
    (see accel.traverse.bin_rays).

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


def walk_pairs_cuda(ds, st, o, d, key, ray, work, t_in, best,
                    slot_base: int = 0, any_hit: bool = False,
                    with_stats: bool = True, lib=None) -> trav.RayBest:
    """Walk the first work[0] (at most P) of the (ray, treelet) pairs
    `key` / `ray` (P,) int32 for rays o, d (N,3) float32 starting from t_in
    (N,) float32, and fold what they find into `best` (a RayBest, updated
    in place and returned) at slots slot_base + pair index; all contiguous
    on one device (see accel.traverse.walk_pairs). `work` (2,) int32 is
    [live pairs, 0]; the call uses its second int as the work counter and
    leaves it at or past the first, so a `work` serves one call
    (`trav.pair_work` makes one).

    CUDA tensors: launches kernel `walk_pairs` on the current stream (no
    synchronise) or raises. CPU tensors: the plain `walk_pairs`.
    with_stats=False leaves the counters untouched. `lib` overrides the
    loaded library."""
    _require_two_level(st)
    dev, n = check_rays(o, d, t_in)
    p = key.shape[0] if key.dim() == 1 else -1
    _check("key", key, (p,), torch.int32, dev)
    _check("ray", ray, (p,), torch.int32, dev)
    _check("work", work, (2,), torch.int32, dev)
    _check("best.word", best.word, (n,), torch.int64, dev)
    s = best.payload.shape[0] if best.payload.dim() == 2 else -1
    _check("best.payload", best.payload, (s, 4), torch.int32, dev)
    for name in trav.RayBest._fields[2:]:
        _check(f"best.{name}", getattr(best, name), (n,), torch.int32, dev)
    if not (0 <= slot_base and slot_base + p <= min(s, trav.NO_SLOT)):
        raise ValueError(f"slots {slot_base}..{slot_base + p} do not fit a "
                         f"payload of {s} rows")
    check_table("ds.tl_nodes", ds.tl_nodes, 64, torch.float32, dev)
    check_table("ds.tl_prims", ds.tl_prims, 32, torch.float32, dev)
    check_table("ds.tl_offsets", ds.tl_offsets, 2, torch.int32, dev)
    if dev.type == "cpu":
        return trav.walk_pairs(ds, st, o, d, key, ray, work, t_in, best,
                               slot_base, any_hit=any_hit,
                               with_stats=with_stats)

    lib = lib or get_lib()
    deepest = _overflow_int(dev)
    stats = ([c.data_ptr() for c in best[2:]] if with_stats
             else [None, None, None])
    if p > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_walk_pairs(
                ds.tl_nodes.data_ptr(), ds.tl_prims.data_ptr(),
                ds.tl_prims.shape[0], ds.tl_offsets.data_ptr(),
                o.data_ptr(), d.data_ptr(), key.data_ptr(), ray.data_ptr(),
                work.data_ptr(), t_in.data_ptr(), p, slot_base,
                best.word.data_ptr(),
                best.payload.data_ptr(), *stats, deepest.data_ptr(),
                int(any_hit), int(st.n_spheres > 0), int(with_stats), stream)
        if rc != 0:
            raise RuntimeError(
                f"walk_pairs kernel launch failed: CUDA error {rc}")
        launches["walk_pairs"] += 1
    return best


def _octants(d):
    """Direction octant of each ray, 0..7: the second sort key of a pair, so
    that the rays of a warp that walk one treelet also head one way."""
    i32 = torch.int32
    return ((d[:, 0] < 0).to(i32) + 2 * (d[:, 1] < 0).to(i32)
            + 4 * (d[:, 2] < 0).to(i32))


def _pass_pairs(st, tid, tnear, octant, t_best, hit, any_hit: bool):
    """The pairs of one pass over the list columns `tid`, `tnear` (N, C):
    every record with a treelet whose entry t is below the ray's best t (for
    any hit only on rays without a hit). Returns (key, ray, work): key
    (N * C,) i32 sorted by treelet * 8 + octant (the rest carry the
    sentinel and come last), ray (N * C,) i32 each sorted pair's ray, work
    (2,) i32 the number of live pairs and 0, all on the card."""
    cols = tid.shape[1]
    live = (tid >= 0) & (tnear < t_best[:, None])
    if any_hit and hit is not None:
        live = live & ~hit[:, None]
    key = torch.where(live, tid * 8 + octant[:, None],
                      trav.pair_sentinel(st)).reshape(-1)
    key, perm = torch.sort(key, stable=True)
    return key, (perm // cols).to(torch.int32), trav.pair_work(live)


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
        bin_rays_cuda, walk_pairs_cuda,
        functools.partial(intersect_treelets_cuda, with_stats=False),
        ds, st, o, d, tmax, any_hit, with_stats, r_list, wave0)


def _requeue(bin_fn, walk, fallback, ds, st, o, d, tmax, any_hit: bool = False,
             with_stats: bool = True, r_list: int = R_LIST,
             wave0: int = WAVE0):
    """The re-queue traversal's passes over three functions with the
    signatures of `bin_rays_cuda(ds, st, o, d, tmax, r_list)`,
    `walk_pairs_cuda(ds, st, o, d, key, ray, work, t_in, best, slot_base,
    any_hit=, with_stats=)` and `intersect_treelets_cuda(ds, st, o, d, tmax,
    any_hit=)`: `intersect_requeue` passes the kernels' wrappers; given the
    plain versions it is the same traversal without a kernel."""
    tid, tnear, ovf = bin_fn(ds, st, o, d, tmax, r_list)
    octant = _octants(d)
    p = tid.numel()
    best = trav.new_ray_best(tmax, 2 * p)
    t_best, hit = tmax, None
    # the lists are in entry t order: pass 0 takes each ray's nearest wave0
    # records, pass 1 the rest (no columns when wave0 = r_list)
    walked = 0
    for k, cols in enumerate((slice(0, wave0), slice(wave0, r_list))):
        key, ray, work = _pass_pairs(st, tid[:, cols], tnear[:, cols],
                                     octant, t_best, hit, any_hit)
        walk(ds, st, o, d, key, ray, work, t_best, best, k * p,
             any_hit=any_hit, with_stats=with_stats)
        t_best, hit = trav.best_t(best)
        walked = cols.stop
    t_best, gid, ridx, b1, b2 = trav.best_hit(best)

    # pairs still live after the last pass: none by construction (every
    # live pair of pass 1 is walked), counted as the JAX package counts them
    rem = ((tid[:, walked:] >= 0) & (tnear[:, walked:] < t_best[:, None])
           ).sum(1, dtype=torch.int32)
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
    return hit, trav.TraversalStats(*best[2:],
                                    truncated=torch.where(need_fb, 0, rem))
