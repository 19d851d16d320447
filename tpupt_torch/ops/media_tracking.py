"""Wrapper of the CUDA grid-medium tracking kernel K6
(csrc/media_tracking.cu).

`tr_grid` (the grid transmittance of ratio tracking) and
`sample_distance_grid` (the delta-tracking distance sample) are what
media/media.py `tr_lane` and `sample_distance_lane` call for the grid lanes
of a scene with grid media.
For tensors on a CUDA device each launches its kernel, built at first use
with nvcc from the package's sources into the git-ignored build directory,
or raises; there is no fallback to the plain version there. For tensors on
the CPU each runs its plain version, media.py `tr_grid_plain` /
`sample_distance_grid_plain`, which is also what the kernel is held against
on the card.

`launches` counts the launches of each entry point and nothing else.
Neither entry point has a backward: both take their lanes detached, on
either device, so a grid medium's transmittance and distance samples carry
no gradient through the ray (queue 1 item 11 in ROADMAP.md).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpupt_torch.media.media import (sample_distance_grid_plain, tr_grid_plain,
                                     tracking_constants)
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "media_tracking"

# launches of each entry point since import (or since zeroed)
launches = {"tr_grid": 0, "sample_distance_grid": 0}

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
    common = [vp] * 12 + [ci]
    lib.tpupt_tr_grid.argtypes = common + [vp, vp]
    lib.tpupt_tr_grid.restype = ci
    lib.tpupt_sample_distance_grid.argtypes = common + [vp, vp, vp]
    lib.tpupt_sample_distance_grid.restype = ci
    return lib


def get_lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            if cuda_is_stale(NAME):
                build()
            _LIB = load(cuda_library(NAME))
        return _LIB


def _args(mt, mi, o, d, t_c, keys, live):
    """The kernel's pointer arguments (the tensors kept alive in the
    returned list) after checking device, type, shape and contiguity."""
    dev, n = o.device, o.shape[0]
    want = {"o": (o, (n, 3), torch.float32), "d": (d, (n, 3), torch.float32),
            "t_c": (t_c, (n,), torch.float32), "live": (live, (n,), torch.bool),
            "mi": (mi, (n,), None), "keys": (keys, (n,), None)}
    for name, (x, shape, dtype) in want.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the lanes on {dev}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(x.shape)}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    m = mt.majorant.shape[0]
    if mt.w2m.shape != (m, 4, 4) or mt.dens_dims.shape != (m, 3):
        raise ValueError("the media table's rows do not agree")
    inv_max, sig_mean = tracking_constants(mt)
    keep = [mt.density.to(torch.float32).contiguous(),
            mt.dens_off.to(torch.int32).contiguous(),
            mt.dens_dims.to(torch.int32).contiguous(),
            mt.w2m.to(torch.float32).contiguous(),
            inv_max.contiguous(), sig_mean.contiguous(),
            mi.to(torch.int32).contiguous(),
            live.to(torch.uint8).contiguous(),
            o.contiguous(), d.contiguous(), t_c.contiguous(),
            # uint32 hash keys held in int64: their low 32 bits
            keys.to(torch.int32).contiguous()]
    for x in keep:
        if x.device != dev:
            raise ValueError(f"the media table is on {x.device}, the lanes "
                             f"on {dev}")
    return keep, [x.data_ptr() for x in keep] + [n]


def _launch(entry, rc):
    if rc != 0:
        raise RuntimeError(f"media_tracking {entry} launch failed: CUDA "
                           f"error {rc}")
    launches[entry] += 1


def tr_grid(mt, mi, o, d, t_c, keys, live, lib=None):
    """Grid transmittance (N,) of ratio tracking (grid.cpp:62) for lanes in
    media mi (N,) over [0, t_c (N,)] along o + t d, hashed from keys (N,);
    lanes outside `live` (N,) bool are not computed (1 for the kernel). CUDA
    tensors: launches the kernel on the current stream (no synchronise) or
    raises; CPU tensors: `tr_grid_plain`. `lib` overrides the loaded
    library (used to time it alone)."""
    o, d, t_c = o.detach(), d.detach(), t_c.detach()
    if o.device.type == "cpu":
        return tr_grid_plain(mt, mi, o, d, t_c, keys)
    keep, ptrs = _args(mt, mi, o, d, t_c, keys, live)
    trg = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    if o.shape[0]:
        lib = lib or get_lib()
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream(o.device).cuda_stream
            _launch("tr_grid", lib.tpupt_tr_grid(
                *ptrs, trg.data_ptr(), stream))
    del keep
    return trg


def sample_distance_grid(mt, mi, o, d, t_c, keys, live, lib=None):
    """(interacted (N,) bool, t (N,)) of delta tracking (grid.cpp:90) for
    lanes in media mi before t_c, as `tr_grid` takes its arguments;
    lanes outside `live` give (False, 0) from the kernel. CPU tensors:
    `sample_distance_grid_plain`."""
    o, d, t_c = o.detach(), d.detach(), t_c.detach()
    if o.device.type == "cpu":
        return sample_distance_grid_plain(mt, mi, o, d, t_c, keys)
    keep, ptrs = _args(mt, mi, o, d, t_c, keys, live)
    n = o.shape[0]
    inter = torch.empty(n, dtype=torch.uint8, device=o.device)
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    if n:
        lib = lib or get_lib()
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream(o.device).cuda_stream
            _launch("sample_distance_grid", lib.tpupt_sample_distance_grid(
                *ptrs, inter.data_ptr(), t.data_ptr(), stream))
    del keep
    return inter.bool(), t
