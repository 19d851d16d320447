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

Both are differentiable where autograd asks for it (an input that requires
grad, with grad mode on): `tr_grid` through `TrGrid`, whose backward is the
kernel's third entry point, `tr_grid_backward` (its plain version
media.py `tr_grid_backward_plain` on the CPU), with respect to the lanes'
o and d, the density atlas, the world-to-medium matrices and the two
tracking constants (through which autograd reaches `med_majorant`,
`med_sigma_a` and `med_sigma_s`); `sample_distance_grid` through
`SampleDistanceGrid`, whose t is 1 / majorant times a sum of draws, so its
backward is one product in plain PyTorch (no kernel) and `interacted`
carries none. On CUDA tensors a backward launches the kernel or raises:
there is no fallback.

`launches` counts the launches of each entry point and nothing else.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from tpupt_torch.media.media import (TR_BWD_COLS, TR_BWD_D, TR_BWD_INV,
                                     TR_BWD_O, TR_BWD_SIG, TR_BWD_W2M,
                                     sample_distance_grid_plain,
                                     tr_grid_backward_plain, tr_grid_plain,
                                     tracking_constants)
from tpupt_torch.utils.build import build_cuda, cuda_is_stale, cuda_library

NAME = "media_tracking"

# launches of each entry point since import (or since zeroed)
launches = {"tr_grid": 0, "sample_distance_grid": 0, "tr_grid_backward": 0}
# the forward entry points (the backward is launched by autograd)
FORWARD = ("tr_grid", "sample_distance_grid")

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
    lib.tpupt_tr_grid_backward.argtypes = common + [vp, vp, vp, vp]
    lib.tpupt_tr_grid_backward.restype = ci
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


def _needs_grad(*xs):
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _detached(mt):
    return mt._replace(density=mt.density.detach(), w2m=mt.w2m.detach(),
                       majorant=mt.majorant.detach(),
                       sigma_a=mt.sigma_a.detach(),
                       sigma_s=mt.sigma_s.detach())


def tr_grid(mt, mi, o, d, t_c, keys, live, lib=None):
    """Grid transmittance (N,) of ratio tracking (grid.cpp:62) for lanes in
    media mi (N,) over [0, t_c (N,)] along o + t d, hashed from keys (N,);
    lanes outside `live` (N,) bool are not computed (1 for the kernel). CUDA
    tensors: launches the kernel on the current stream (no synchronise) or
    raises; CPU tensors: `tr_grid_plain`. Differentiable (`TrGrid`) where
    o, d or the media table's float tables require grad. `lib` overrides
    the loaded library (used to time it alone)."""
    inv_max, sig_mean = tracking_constants(mt)
    if _needs_grad(o, d, mt.density, mt.w2m, inv_max, sig_mean):
        return TrGrid.apply(mt.density, mt.w2m, inv_max, sig_mean, o, d,
                            mt, mi, t_c, keys, live)
    return _tr_grid(_detached(mt), mi, o.detach(), d.detach(),
                    t_c.detach(), keys, live, lib)


def _tr_grid(mt, mi, o, d, t_c, keys, live, lib=None):
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


def tr_grid_backward(mt, mi, o, d, t_c, keys, live, g_trg, lib=None):
    """The adjoint of `tr_grid` for the cotangent g_trg (N,) of its
    transmittance: (g_lane (N, 20), g_density (T,)), as media.py
    `tr_grid_backward_plain` returns them (zeros on the lanes outside
    `live`). CUDA tensors: launches the kernel's backward entry point on
    the current stream or raises; CPU tensors: the plain version."""
    mt = _detached(mt)
    o, d, t_c, g_trg = o.detach(), d.detach(), t_c.detach(), g_trg.detach()
    if o.device.type == "cpu":
        return tr_grid_backward_plain(mt, mi, o, d, t_c, keys, g_trg, live)
    if g_trg.shape != t_c.shape or g_trg.dtype != torch.float32:
        raise ValueError(f"g_trg must be float32 of shape {tuple(t_c.shape)}")
    keep, ptrs = _args(mt, mi, o, d, t_c, keys, live)
    n = o.shape[0]
    g = g_trg.contiguous()
    g_lane = torch.empty((n, TR_BWD_COLS), dtype=torch.float32,
                         device=o.device)
    g_density = torch.zeros_like(keep[0])
    if n:
        lib = lib or get_lib()
        with torch.cuda.device(o.device):
            stream = torch.cuda.current_stream(o.device).cuda_stream
            _launch("tr_grid_backward", lib.tpupt_tr_grid_backward(
                *ptrs, g.data_ptr(), g_lane.data_ptr(), g_density.data_ptr(),
                stream))
    del keep
    return g_lane, g_density


def _per_medium(mi, values, m):
    """Per-lane values (N, ...) summed into their media's rows (m, ...)."""
    return values.new_zeros((m,) + values.shape[1:]).index_add_(0, mi, values)


class TrGrid(torch.autograd.Function):
    """`tr_grid` with its backward: the kernel's (or the plain version's)
    per-lane gradients, summed per medium by `index_add` after the launch;
    the atlas gradient is the kernel's sum. Each call's backward returns one
    atlas-sized tensor, which autograd adds into the table's gradient as
    the backwards run: none is kept a call."""

    @staticmethod
    def forward(ctx, density, w2m, inv_max, sig_mean, o, d, mt, mi, t_c,
                keys, live):
        mt = _detached(mt)
        o, d, t_c = o.detach(), d.detach(), t_c.detach()
        ctx.save_for_backward(o, d, t_c)
        ctx.lanes = (mt, mi, keys, live)
        return _tr_grid(mt, mi, o, d, t_c, keys, live)

    @staticmethod
    def backward(ctx, g_trg):
        o, d, t_c = ctx.saved_tensors
        mt, mi, keys, live = ctx.lanes
        g_lane, g_density = tr_grid_backward(mt, mi, o, d, t_c, keys, live,
                                             g_trg)
        m = mt.majorant.shape[0]
        need = ctx.needs_input_grad
        g_w2m = g_inv = g_sig = None
        if need[1]:
            rows = g_lane[:, TR_BWD_W2M:TR_BWD_W2M + 12]
            g_w2m = torch.cat([_per_medium(mi, rows, m).reshape(m, 3, 4),
                               rows.new_zeros((m, 1, 4))], 1)
        if need[2]:
            g_inv = _per_medium(mi, g_lane[:, TR_BWD_INV], m)
        if need[3]:
            g_sig = _per_medium(mi, g_lane[:, TR_BWD_SIG], m)
        return (g_density if need[0] else None, g_w2m, g_inv, g_sig,
                g_lane[:, TR_BWD_O:TR_BWD_O + 3] if need[4] else None,
                g_lane[:, TR_BWD_D:TR_BWD_D + 3] if need[5] else None,
                None, None, None, None, None)


def sample_distance_grid(mt, mi, o, d, t_c, keys, live, lib=None):
    """(interacted (N,) bool, t (N,)) of delta tracking (grid.cpp:90) for
    lanes in media mi before t_c, as `tr_grid` takes its arguments;
    lanes outside `live` give (False, 0) from the kernel. CPU tensors:
    `sample_distance_grid_plain`. t is differentiable
    (`SampleDistanceGrid`) with respect to the media's 1 / majorant where
    the majorant requires grad."""
    inv_max, _ = tracking_constants(mt)
    if _needs_grad(inv_max):
        return SampleDistanceGrid.apply(inv_max, mt, mi, o, d, t_c, keys,
                                        live)
    return _sample_distance_grid(_detached(mt), mi, o.detach(), d.detach(),
                                 t_c.detach(), keys, live, lib)


def _sample_distance_grid(mt, mi, o, d, t_c, keys, live, lib=None):
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


class SampleDistanceGrid(torch.autograd.Function):
    """`sample_distance_grid` with t's gradient: t = inv_max * (a sum of
    exponential draws that the density does not move: it only decides
    where the walk stops), so dt / d inv_max = t / inv_max; the density,
    the lanes' o and d and `interacted` get none, as in jax.grad of the
    JAX package's loop."""

    @staticmethod
    def forward(ctx, inv_max, mt, mi, o, d, t_c, keys, live):
        inter, t = _sample_distance_grid(_detached(mt), mi, o.detach(),
                                         d.detach(), t_c.detach(), keys,
                                         live)
        ctx.mark_non_differentiable(inter)
        ctx.save_for_backward(inv_max.detach(), t)
        ctx.mi = mi
        return inter, t

    @staticmethod
    def backward(ctx, g_inter, g_t):
        inv_max, t = ctx.saved_tensors
        g_lane = g_t * t / inv_max[ctx.mi]
        return (_per_medium(ctx.mi, g_lane, inv_max.shape[0]),
                None, None, None, None, None, None, None)
