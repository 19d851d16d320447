"""Wrapper of the CUDA wide-BVH traversal kernel (csrc/traverse_wide.cu).

`intersect_wide_cuda` is what the path integrator calls for every closest-hit
and any-hit traversal of a scene with single-level tables (a scene with
two-level tables goes through ops/traverse_treelets.py). For tensors on a CUDA device it launches the kernel,
built at first use with nvcc from the package's sources into the git-ignored
build directory, or raises; it never gives way to the plain version there. For
tensors on the CPU it calls the plain PyTorch walker
`accel.traverse.intersect_wide`, which is also what the kernel is held
against on the card.

`launches` counts launches of the static instances and nothing else;
`launches_motion` those of the motion instance, which a scene with
`st.has_motion` launches (its triangles lerped to each ray's shutter time).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpupt_torch.accel import traverse as trav
from tpupt_torch.scene.device import DT_WIDTH
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "traverse_wide"

launches = 0  # static-instance launches since import (or since zeroed)
launches_motion = 0  # motion-instance launches, likewise

_LOCK = threading.Lock()
_LIB = None
_DEEPEST = {}  # device index -> one-int tensor the kernels report overflow in


def build(extra_flags=(), out: str = None):
    """Compile the kernel into a shared library. Returns (path, what nvcc
    printed); see utils.build.build_cuda."""
    return build_cuda(NAME, extra_flags, out)


def load(path: str):
    """ctypes handle of a library made by `build`, with argtypes set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_traverse_wide.argtypes = (
        [vp, vp, ci, vp, vp, vp, ci] + [vp] * 9 + [ci, ci, ci, vp, vp, vp])
    lib.tpupt_traverse_wide.restype = ci
    return lib


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if cuda_is_stale(NAME):
                build()
            _LIB = load(cuda_library(NAME))
        return _LIB


def _check(name, x, shape, dtype, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the rays are on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rays(o, d, tmax):
    """(device, N) of a ray batch after checking type, dtype, shape,
    contiguity and that all three lie on one device."""
    if not isinstance(o, torch.Tensor):
        raise TypeError(f"o must be a tensor, got {type(o).__name__}")
    dev = o.device
    n = o.shape[0] if o.dim() == 2 else -1
    _check("o", o, (n, 3), torch.float32, dev)
    _check("d", d, (n, 3), torch.float32, dev)
    _check("tmax", tmax, (n,), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no traversal kernel for device type {dev.type!r}")
    return dev, n


def check_table(name, x, width, dtype, dev):
    _check(name, x, (x.shape[0] if x.dim() == 2 else -1, width), dtype, dev)


def alloc_outputs(n, dev, with_stats, overflow_ints=None):
    """Uninitialised (t, b1, b2, gid, ridx, nodes, leaves, tests) for a
    launch, the overflow int of `dev` (from `overflow_ints`, a dict by device
    index; default: the BVH kernels'), and the counters' pointers (None
    without stats: the counters then come back as zeros)."""
    f32, i32 = torch.float32, torch.int32
    t, b1, b2 = (torch.empty(n, dtype=f32, device=dev) for _ in range(3))
    gid, ridx = (torch.empty(n, dtype=i32, device=dev) for _ in range(2))
    if with_stats:
        nodes, leaves, tests = (torch.empty(n, dtype=i32, device=dev)
                                for _ in range(3))
        ptrs = [nodes.data_ptr(), leaves.data_ptr(), tests.data_ptr()]
    else:
        nodes = leaves = tests = torch.zeros(n, dtype=i32, device=dev)
        ptrs = [None, None, None]
    if overflow_ints is None:
        overflow_ints = _DEEPEST
    deepest = overflow_ints.get(dev.index)
    if deepest is None:
        deepest = overflow_ints[dev.index] = torch.zeros(1, dtype=i32,
                                                         device=dev)
    return (t, b1, b2, gid, ridx, nodes, leaves, tests), deepest, ptrs


def intersect_wide_cuda(ds, st, o, d, tmax, any_hit: bool = False,
                        with_stats: bool = True, lib=None, time=None):
    """(Hit, TraversalStats) of rays o, d (N,3) float32, tmax (N,) float32,
    all contiguous and on one device, against the wide BVH of `ds`. In a
    motion scene (`st.has_motion`) the triangles are lerped to each ray's
    shutter `time` (N,) float32 in [0,1] (mid-shutter when None) through
    `ds.prim_rows_dt`; a static scene ignores `time`.

    CUDA tensors: launches the kernel on the current stream (no synchronise)
    or raises; a motion scene launches the motion instance. CPU tensors: the
    plain `intersect_wide`. with_stats=False leaves the counters out of the
    kernel and returns zeros for them. `lib` overrides the loaded library
    (used to time other builds)."""
    global launches, launches_motion
    dev, n = check_rays(o, d, tmax)
    check_table("ds.wide_nodes", ds.wide_nodes, 64, torch.float32, dev)
    check_table("ds.prim_rows", ds.prim_rows, 32, torch.float32, dev)
    motion = bool(st.has_motion)
    if motion:
        _check("ds.prim_rows_dt", ds.prim_rows_dt,
               (ds.prim_rows.shape[0], DT_WIDTH), torch.float32, dev)
        if time is None:
            time = torch.full((n,), 0.5, device=dev)
        _check("time", time, (n,), torch.float32, dev)
    if dev.type == "cpu":
        return trav.intersect_wide(ds, st, o, d, tmax, any_hit=any_hit,
                                   time=time)

    lib = lib or get_lib()
    outs, deepest, stat_ptrs = alloc_outputs(n, dev, with_stats)
    t, b1, b2, gid, ridx, nodes, leaves, tests = outs
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_traverse_wide(
                ds.wide_nodes.data_ptr(), ds.prim_rows.data_ptr(),
                ds.prim_rows.shape[0], o.data_ptr(), d.data_ptr(),
                tmax.data_ptr(), n, t.data_ptr(), b1.data_ptr(),
                b2.data_ptr(), gid.data_ptr(), ridx.data_ptr(), *stat_ptrs,
                deepest.data_ptr(), int(any_hit), int(st.n_spheres > 0),
                int(with_stats),
                ds.prim_rows_dt.data_ptr() if motion else None,
                time.data_ptr() if motion else None, stream)
        if rc != 0:
            raise RuntimeError(f"traverse_wide kernel launch failed: CUDA error {rc}")
        if motion:
            launches_motion += 1
        else:
            launches += 1
    p_obj = trav.quadric_hit_point(ds.prim_rows, st, o, d, t, ridx)
    hit = trav.Hit(valid=gid >= 0, t=t, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, trav.TraversalStats(nodes, leaves, tests)


def raise_on_overflow(overflow_ints, what: str, capacity: int):
    """Synchronise and raise if any ray since the last check needed a deeper
    stack than `capacity` (its walk then skipped nodes)."""
    for index, deepest in overflow_ints.items():
        v = int(deepest.item())
        if v:
            deepest.zero_()
            raise RuntimeError(
                f"{what} stack overflow on cuda:{index}: depth {v} > "
                f"{capacity}")


def check_stack_depth():
    """`raise_on_overflow` for the two wide-BVH kernels."""
    raise_on_overflow(_DEEPEST, "wide-BVH", trav.WIDE_STACK)
