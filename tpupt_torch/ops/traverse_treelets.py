"""Wrapper of the CUDA two-level traversal kernel (csrc/traverse_treelets.cu).

`intersect_treelets_cuda` is what the path integrator calls for every
closest-hit and any-hit traversal of a scene uploaded with two-level tables
(`SceneStatics.two_level`). For tensors on a CUDA device it launches the
kernel, built at first use with nvcc into the git-ignored build directory, or
raises; it never gives way to the plain version there. For tensors on the CPU
it calls the plain PyTorch walker `accel.traverse.intersect_two_level`, which
is also what the kernel is held against on the card.

`launches` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops.traverse_wide import (alloc_outputs, check_rays,
                                           check_table)
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "traverse_treelets"

launches = 0  # kernel launches since import (or since a caller zeroed it)

_LOCK = threading.Lock()
_LIB = None


def build(extra_flags=(), out: str = None):
    """Compile the kernel into a shared library. Returns (path, what nvcc
    printed); see utils.build.build_cuda."""
    return build_cuda(NAME, extra_flags, out)


def load(path: str):
    """ctypes handle of a library made by `build`, with argtypes set."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tpupt_traverse_treelets.argtypes = (
        [vp, vp, vp, ci, vp, vp, vp, vp, ci] + [vp] * 9 + [ci, ci, ci, vp])
    lib.tpupt_traverse_treelets.restype = ci
    return lib


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if cuda_is_stale(NAME):
                build()
            _LIB = load(cuda_library(NAME))
        return _LIB


def intersect_treelets_cuda(ds, st, o, d, tmax, any_hit: bool = False,
                            with_stats: bool = True, lib=None):
    """(Hit, TraversalStats) of rays o, d (N,3) float32, tmax (N,) float32,
    all contiguous and on one device, against the two-level tables of `ds`.

    CUDA tensors: launches the kernel on the current stream (no synchronise)
    or raises. CPU tensors: the plain `intersect_two_level`. with_stats=False
    leaves the counters out of the kernel and returns zeros for them.
    `lib` overrides the loaded library (used to time other builds)."""
    global launches
    if not st.two_level:
        raise ValueError("the scene was uploaded without two-level tables")
    dev, n = check_rays(o, d, tmax)
    check_table("ds.top_nodes", ds.top_nodes, 64, torch.float32, dev)
    check_table("ds.tl_nodes", ds.tl_nodes, 64, torch.float32, dev)
    check_table("ds.tl_prims", ds.tl_prims, 32, torch.float32, dev)
    check_table("ds.tl_offsets", ds.tl_offsets, 2, torch.int32, dev)
    if dev.type == "cpu":
        return trav.intersect_two_level(ds, st, o, d, tmax, any_hit=any_hit)

    lib = lib or get_lib()
    outs, deepest, stat_ptrs = alloc_outputs(n, dev, with_stats)
    t, b1, b2, gid, ridx, nodes, leaves, tests = outs
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpupt_traverse_treelets(
                ds.top_nodes.data_ptr(), ds.tl_nodes.data_ptr(),
                ds.tl_prims.data_ptr(), ds.tl_prims.shape[0],
                ds.tl_offsets.data_ptr(), o.data_ptr(), d.data_ptr(),
                tmax.data_ptr(), n, t.data_ptr(), b1.data_ptr(),
                b2.data_ptr(), gid.data_ptr(), ridx.data_ptr(), *stat_ptrs,
                deepest.data_ptr(), int(any_hit), int(st.n_spheres > 0),
                int(with_stats), stream)
        if rc != 0:
            raise RuntimeError(
                f"traverse_treelets kernel launch failed: CUDA error {rc}")
        launches += 1
    p_obj = trav.quadric_hit_point(ds.tl_prims, st, o, d, t, ridx)
    hit = trav.Hit(valid=gid >= 0, t=t, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return hit, trav.TraversalStats(nodes, leaves, tests)
