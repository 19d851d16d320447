"""ctypes loader for the native builders: the sweep-SAH BVH, the SAH kd-tree,
the restricted BSP (RBSP) and the unrestricted-BSP family, and the convex
cell area they share (compiled on demand with g++ into the package's
git-ignored build directory).

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
        lib.tpb_build_kdtree.argtypes = [
            ctypes.c_int, _f32p, _f32p, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_i32p), ctypes.POINTER(_f32p),
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), _i32p, _i32p, _f32p, _f32p, _f64p]
        lib.tpb_build_kdtree.restype = ctypes.c_int
        lib.tpb_build_rbsp.argtypes = [
            ctypes.c_int, ctypes.c_int, _f64p, _f64p, _f64p, _f32p, _f32p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(_i32p), ctypes.POINTER(_f32p),
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), _i32p, _i32p, _f64p]
        lib.tpb_build_rbsp.restype = ctypes.c_int
        lib.tpb_build_bsp.argtypes = [
            ctypes.c_int, _f64p, _i32p, _f64p, _f32p, _f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
            ctypes.POINTER(_i32p), ctypes.POINTER(_f32p),
            ctypes.POINTER(_f32p), ctypes.POINTER(_i32p),
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p),
            _i32p, _i32p, _i32p, _i32p, _f64p]
        lib.tpb_build_bsp.restype = ctypes.c_int
        lib.tpb_polytope_cut_area.restype = ctypes.c_double
        lib.tpb_polytope_cut_area.argtypes = [
            _f32p, _f32p, ctypes.c_int, _f64p, _f64p]
        _LIB = lib
        return lib


def _take(lib, ptr, n, dtype):
    """Copy a malloc'd output array into numpy and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(max(n, 1),)).copy()
    lib.tpb_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr.astype(dtype, copy=False)[:n]


def _fp(a):
    return a.ctypes.data_as(_f32p)


def _dp(a):
    return a.ctypes.data_as(_f64p)


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


def build_kdtree(prim_lo, prim_hi, isect_cost=80.0, traversal_cost=1.0,
                 empty_bonus=0.5, max_prims=1, max_depth=-1):
    """SAH kd-tree (kdtreeaccel.cpp parity: default costs 80/1, emptybonus
    0.5, maxprims 1). Returns a dict of flat arrays."""
    lib = get_lib()
    n = len(prim_lo)
    lo = np.ascontiguousarray(prim_lo, np.float32)
    hi = np.ascontiguousarray(prim_hi, np.float32)
    o_fl, o_sp = _i32p(), _f32p()
    o_ab, o_np, o_pi = _i32p(), _i32p(), _i32p()
    n_pi, n_nodes = ctypes.c_int32(), ctypes.c_int32()
    blo = np.zeros(3, np.float32)
    bhi = np.zeros(3, np.float32)
    bt = ctypes.c_double()
    lib.tpb_build_kdtree(n, _fp(lo), _fp(hi), isect_cost, traversal_cost,
                         empty_bonus, max_prims, max_depth,
                         ctypes.byref(o_fl), ctypes.byref(o_sp),
                         ctypes.byref(o_ab), ctypes.byref(o_np),
                         ctypes.byref(o_pi), ctypes.byref(n_pi),
                         ctypes.byref(n_nodes), _fp(blo), _fp(bhi),
                         ctypes.byref(bt))
    nn = n_nodes.value
    return dict(
        flags=_take(lib, o_fl, nn, np.int32),
        split=_take(lib, o_sp, nn, np.float32),
        above=_take(lib, o_ab, nn, np.int32),
        nprims=_take(lib, o_np, nn, np.int32),
        prim_ids=_take(lib, o_pi, n_pi.value, np.int32),
        bounds_lo=blo, bounds_hi=bhi, n_nodes=nn, build_seconds=bt.value,
    )


def build_rbsp(dirs, proj_min, proj_max, world_lo, world_hi,
               isect_cost=80.0, traversal_cost=1.0, empty_bonus=0.5,
               max_prims=1, max_depth=-1):
    """Restricted BSP with exact polytope-area SAH (rbsp.cpp parity).
    dirs: (D,3) unit directions; proj_min/max: (N,D) per-prim projected
    bounds (the reference's Triangle::getBounds(Vector3f))."""
    lib = get_lib()
    dirs = np.ascontiguousarray(dirs, np.float64)
    pmin = np.ascontiguousarray(proj_min, np.float64)
    pmax = np.ascontiguousarray(proj_max, np.float64)
    n, n_dirs = pmin.shape
    wlo = np.ascontiguousarray(world_lo, np.float32)
    whi = np.ascontiguousarray(world_hi, np.float32)
    o_fl, o_sp = _i32p(), _f32p()
    o_ab, o_np, o_pi = _i32p(), _i32p(), _i32p()
    n_pi, n_nodes = ctypes.c_int32(), ctypes.c_int32()
    bt = ctypes.c_double()
    lib.tpb_build_rbsp(n, n_dirs, _dp(dirs), _dp(pmin), _dp(pmax),
                       _fp(wlo), _fp(whi), isect_cost, traversal_cost,
                       empty_bonus, max_prims, max_depth,
                       ctypes.byref(o_fl), ctypes.byref(o_sp),
                       ctypes.byref(o_ab), ctypes.byref(o_np),
                       ctypes.byref(o_pi), ctypes.byref(n_pi),
                       ctypes.byref(n_nodes), ctypes.byref(bt))
    nn = n_nodes.value
    return dict(
        flags=_take(lib, o_fl, nn, np.int32),
        split=_take(lib, o_sp, nn, np.float32),
        above=_take(lib, o_ab, nn, np.int32),
        nprims=_take(lib, o_np, nn, np.int32),
        prim_ids=_take(lib, o_pi, n_pi.value, np.int32),
        n_nodes=nn, n_dirs=n_dirs, dirs=dirs, build_seconds=bt.value,
    )


BSP_POLICIES = {"cluster": 0, "arbitrary": 1, "random": 2, "paper": 3}
BSP_KD_MODES = {"": 0, "withkd": 1, "fastkd": 2}


def build_bsp(pts, npts, normals, world_lo, world_hi, policy="cluster",
              kd_mode="", k=3, isect_cost=80.0, traversal_cost=5.0,
              kd_traversal_cost=1.0, empty_bonus=0.0, max_prims=1,
              max_depth=-1, seed=1):
    """Unrestricted-BSP family with per-node direction policies
    (bspNodeBased.cpp / bspPaper.cpp parity). pts: (N,8,3) representative
    points per prim; npts: (N,) valid count; normals: (N,3)."""
    lib = get_lib()
    pts = np.ascontiguousarray(pts, np.float64)
    npts = np.ascontiguousarray(npts, np.int32)
    normals = np.ascontiguousarray(normals, np.float64)
    n = len(npts)
    wlo = np.ascontiguousarray(world_lo, np.float32)
    whi = np.ascontiguousarray(world_hi, np.float32)
    o_fl, o_dir, o_sp = _i32p(), _f32p(), _f32p()
    o_ab, o_np, o_pi = _i32p(), _i32p(), _i32p()
    n_pi, n_nodes = ctypes.c_int32(), ctypes.c_int32()
    n_kd, n_bsp = ctypes.c_int32(), ctypes.c_int32()
    bt = ctypes.c_double()
    lib.tpb_build_bsp(
        n, _dp(pts), npts.ctypes.data_as(_i32p), _dp(normals), _fp(wlo),
        _fp(whi), BSP_POLICIES[policy], BSP_KD_MODES[kd_mode], k,
        isect_cost, traversal_cost, kd_traversal_cost, empty_bonus,
        max_prims, max_depth, seed,
        ctypes.byref(o_fl), ctypes.byref(o_dir), ctypes.byref(o_sp),
        ctypes.byref(o_ab), ctypes.byref(o_np), ctypes.byref(o_pi),
        ctypes.byref(n_pi), ctypes.byref(n_nodes), ctypes.byref(n_kd),
        ctypes.byref(n_bsp), ctypes.byref(bt))
    nn = n_nodes.value
    return dict(
        flags=_take(lib, o_fl, nn, np.int32),
        ndir=_take(lib, o_dir, nn * 3, np.float32).reshape(-1, 3),
        split=_take(lib, o_sp, nn, np.float32),
        above=_take(lib, o_ab, nn, np.int32),
        nprims=_take(lib, o_np, nn, np.int32),
        prim_ids=_take(lib, o_pi, n_pi.value, np.int32),
        n_nodes=nn, n_kd_nodes=n_kd.value, n_bsp_nodes=n_bsp.value,
        build_seconds=bt.value,
    )


def polytope_cut_area(box_lo, box_hi, cut_dirs, cut_ts) -> float:
    """Exact convex-cell surface area after plane cuts (kDOPMesh parity,
    exposed for the kdop.cpp-style tests)."""
    lib = get_lib()
    lo = np.ascontiguousarray(box_lo, np.float32)
    hi = np.ascontiguousarray(box_hi, np.float32)
    dirs = np.ascontiguousarray(cut_dirs, np.float64).reshape(-1, 3)
    ts = np.ascontiguousarray(cut_ts, np.float64)
    return float(lib.tpb_polytope_cut_area(_fp(lo), _fp(hi), len(dirs),
                                           _dp(dirs), _dp(ts)))
