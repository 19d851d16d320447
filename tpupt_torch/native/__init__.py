"""ctypes loader for the native sweep-SAH BVH build (compiled on demand
with g++ into the package's git-ignored build directory).

A failed compile raises: the caller does not fall back to another build method."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from tpupt_torch.utils.build import BUILD_DIR, compile_shared, is_stale

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "builders.cpp")
_SO = os.path.join(BUILD_DIR, "libtpupt_builders.so")
_LOCK = threading.Lock()
_LIB = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if is_stale(_SO, _SRC):
            compile_shared(["g++", "-O2", "-shared", "-fPIC", "-std=c++17"],
                           _SRC, _SO)
        lib = ctypes.CDLL(_SO)
        lib.tpb_free.argtypes = [ctypes.c_void_p]
        lib.tpb_free.restype = None
        lib.tpb_build_bvh.argtypes = [
            ctypes.c_int, _f32p, _f32p, ctypes.c_float, ctypes.c_float,
            ctypes.c_int,
            ctypes.POINTER(_f32p), ctypes.POINTER(_f32p),
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), _i32p, _f64p]
        lib.tpb_build_bvh.restype = ctypes.c_int
        _LIB = lib
        return lib


def _take(lib, ptr, n, dtype):
    """Copy a malloc'd output array into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(max(n, 1),)).copy()
    lib.tpb_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr.astype(dtype, copy=False)[:n]


def build_bvh_sah(prim_lo, prim_hi, isect_cost=8.0, traversal_cost=1.0,
                  max_prims=4):
    """Exact sweep-SAH BVH (bvh.cpp:242-321 parity). Returns a BVHArrays."""
    from tpupt_torch.accel.bvh import BVHArrays

    lib = get_lib()
    n = len(prim_lo)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    o_lo, o_hi = _f32p(), _f32p()
    o_r, o_f, o_c, o_a, o_p = (_i32p() for _ in range(5))
    n_nodes = ctypes.c_int32()
    bt = ctypes.c_double()
    lib.tpb_build_bvh(n, lo.ctypes.data_as(_f32p), hi.ctypes.data_as(_f32p),
                      isect_cost, traversal_cost, max_prims,
                      ctypes.byref(o_lo), ctypes.byref(o_hi),
                      ctypes.byref(o_r), ctypes.byref(o_f), ctypes.byref(o_c),
                      ctypes.byref(o_a), ctypes.byref(o_p),
                      ctypes.byref(n_nodes), ctypes.byref(bt))
    nn = n_nodes.value
    b = BVHArrays(
        lo=_take(lib, o_lo, nn * 3, np.float32).reshape(-1, 3),
        hi=_take(lib, o_hi, nn * 3, np.float32).reshape(-1, 3),
        right=_take(lib, o_r, nn, np.int32),
        first=_take(lib, o_f, nn, np.int32),
        count=_take(lib, o_c, nn, np.int32),
        axis=_take(lib, o_a, nn, np.int32),
        prim_ids=_take(lib, o_p, n, np.int32),
    )
    b.build_seconds = bt.value
    return b
