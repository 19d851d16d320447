"""Wrapper of the CUDA kd-tree / RBSP / BSP traversal kernel
(csrc/traverse_kdbsp.cu).

`intersect_kdbsp_cuda` is what the path integrator calls for every
closest-hit and any-hit traversal of a scene rendered with one of the thesis
accelerators (`Accelerator "kdtree"`, `"rbsp"`, `"bsp..."`). For tensors on a
CUDA device it launches the kernel, built at first use with nvcc into the
git-ignored build directory, or raises; it never gives way to the plain
version there. For tensors on the CPU it calls the plain PyTorch walker
`accel.kdbsp.intersect_kdbsp`, which is also what the kernel is held against
on the card.

`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpupt_torch.accel import kdbsp
from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops.traverse_wide import (alloc_outputs, check_rays,
                                           check_table, raise_on_overflow)
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "traverse_kdbsp"

launches = 0  # kernel launches since import (or since a caller zeroed it)

_LOCK = threading.Lock()
_LIB = None
_OVERFLOW = {}  # device index -> one-int tensor the kernel reports overflow in


def build(extra_flags=(), out: str = None):
    """Compile the kernel into a shared library. Returns (path, what nvcc
    printed); see utils.build.build_cuda."""
    return build_cuda(NAME, extra_flags, out)


def load(path: str):
    """ctypes handle of a library made by `build`, with argtypes set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_traverse_kdbsp.argtypes = (
        [vp, vp, ci, vp, vp, vp, vp, vp, ci] + [vp] * 9 + [ci, ci, ci, vp])
    lib.tpupt_traverse_kdbsp.restype = ci
    return lib


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if cuda_is_stale(NAME):
                build()
            _LIB = load(cuda_library(NAME))
        return _LIB


def intersect_kdbsp_cuda(ds, st, o, d, tmax, any_hit: bool = False,
                         with_stats: bool = True, lib=None, time=None):
    """(Hit, TraversalStats) of rays o, d (N,3) float32, tmax (N,) float32,
    all contiguous and on one device, through the kd / RBSP / BSP tree in the
    `alt_*` tables of `ds`. `time` is ignored: in a motion scene the tree is
    built over the shutter's union and tests the prims as they stand at
    shutter open, as in the JAX package.

    CUDA tensors: launches the kernel on the current stream (no synchronise)
    or raises. CPU tensors: the plain `intersect_kdbsp`. with_stats=False
    leaves the counters out of the kernel and returns zeros for them.
    `lib` overrides the loaded library (used to time other builds)."""
    global launches
    kdbsp.check_tree(st)
    dev, n = check_rays(o, d, tmax)
    check_table("ds.alt_nodes", ds.alt_nodes, 8, torch.float32, dev)
    check_table("ds.alt_prim_rows", ds.alt_prim_rows, 32, torch.float32, dev)
    for name in ("world_lo", "world_hi"):
        x = getattr(ds, name)
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != (3,) or not x.is_contiguous()):
            raise ValueError(f"ds.{name} must be 3 contiguous float32 on {dev}")
    if dev.type == "cpu":
        return kdbsp.intersect_kdbsp(ds, st, o, d, tmax, any_hit=any_hit)

    lib = lib or get_lib()
    outs, overflow, stat_ptrs = alloc_outputs(n, dev, with_stats, _OVERFLOW)
    t, b1, b2, gid, ridx, nodes, leaves, tests = outs
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_traverse_kdbsp(
                ds.alt_nodes.data_ptr(), ds.alt_prim_rows.data_ptr(),
                ds.alt_prim_rows.shape[0], ds.world_lo.data_ptr(),
                ds.world_hi.data_ptr(), o.data_ptr(), d.data_ptr(),
                tmax.data_ptr(), n, t.data_ptr(), b1.data_ptr(),
                b2.data_ptr(), gid.data_ptr(), ridx.data_ptr(), *stat_ptrs,
                overflow.data_ptr(), int(any_hit), int(st.n_spheres > 0),
                int(with_stats), stream)
        if rc != 0:
            raise RuntimeError(
                f"traverse_kdbsp kernel launch failed: CUDA error {rc}")
        launches += 1
    p_obj = trav.quadric_hit_point(ds.alt_prim_rows, st, o, d, t, ridx)
    hit = trav.Hit(valid=gid >= 0, t=t, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, trav.TraversalStats(nodes, leaves, tests)


def check_stack_depth():
    """Synchronise and raise if any ray since the last check needed a deeper
    stack than the kernel has (its walk then skipped nodes)."""
    raise_on_overflow(_OVERFLOW, "kd/BSP", kdbsp.KD_STACK)
