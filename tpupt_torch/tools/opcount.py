"""Count the PyTorch operations one sample of a render dispatches, on the
CPU: a device-free stand-in for the kernel launches of a sample on the card,
where each non-view operation is one launch. The traversal calls are
counted apart (one hand-written kernel each on the card, the plain walker's
many operations here), and their operations are left out of the totals.

    python -m tpupt_torch.tools.opcount scene.pbrt [--resolution WxH]
        [--depth D] [--spectral]

Prints one JSON line: the scene's material families, the traversal calls
of one sample (of `mlt`, one mutation step; of `sppm`, one camera and one
photon pass), the other operations of that sample in all and without the
view operations, and the ten most frequent. The grid-medium tracking
calls of a volpath scene (kernel K6 on the card, ops/media_tracking.py) are
counted apart too: their number, and the non-view operations their plain
loops dispatch here, which the card does not launch.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpupt_torch.integrators.path import Renderer
from tpupt_torch.ops import media_tracking
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file

# operations that only make a view (no launch on the card)
_VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze",
          "squeeze", "t", "permute", "alias", "as_strided", "detach",
          "transpose", "unbind", "split", "split_with_sizes", "lift_fresh",
          "view_as_real", "_reshape_alias"}


class OpCounter(TorchDispatchMode):
    """Counts every ATen operation dispatched inside the `with` block."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.tracking = collections.Counter()
        self.paused = False
        self.in_tracking = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            sink = self.tracking if self.in_tracking else self.counts
            sink[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))

    def totals(self) -> dict:
        non_view = sum(c for k, c in self.counts.items() if k not in _VIEWS)
        return {"ops": sum(self.counts.values()), "non_view_ops": non_view,
                "most_frequent": self.counts.most_common(10)}


def count_sample(renderer: Renderer, sample_idx: int = 0) -> dict:
    """The operations of one sample of `renderer` outside its traversal
    calls, and the number of those calls (after a warm-up sample, so that
    one-time table uploads are left out). Under `mlt` and `sppm`, whose
    drivers do not run the sample loop: one mutation step of
    `MLTRenderer` (one chain a lane of the renderer's batch), and one
    camera pass and one photon pass of `SPPMRenderer` (one photon a
    pixel)."""
    name = renderer.scene.integrator.name
    if name == "mlt":
        from tpupt_torch.integrators.mlt import MLTRenderer

        mr = MLTRenderer(renderer)
        gen = torch.Generator().manual_seed(0)
        u = torch.rand((mr.n, mr.n_dims), generator=gen)
        depth = torch.randint(0, mr.max_depth + 1, (mr.n,), generator=gen,
                              dtype=torch.int32)
        L, pr = mr.eval_path(u, depth)
        splat = torch.zeros((mr.xres * mr.yres, 3))
        return count_ops(renderer, lambda: mr.step(u, depth, L, pr, splat,
                                                   sample_idx))
    if name == "sppm":
        from tpupt_torch.integrators.sppm import SPPMRenderer

        sr = SPPMRenderer(renderer)

        def passes():
            vp = sr.camera_pass(sample_idx)
            radius = torch.full((sr.npix_pad,), sr.r0)
            cell = torch.amax(radius) * 1.0001
            sr.photon_pass(sample_idx, vp, radius,
                           renderer.ds.world_lo - 2 * cell, cell)
        return count_ops(renderer, passes)
    renderer.render(spp=1)
    return count_ops(renderer, lambda: renderer._spp(renderer.new_film(),
                                                     sample_idx))


def count_ops(renderer: Renderer, run) -> dict:
    """The operations `run()` dispatches outside the traversal calls of
    `renderer` (and the grid-medium tracking calls), and those calls."""
    counter = OpCounter()
    calls = []
    isect = renderer._isect

    def paused(*args, **kw):
        counter.paused = True
        try:
            return isect(*args, **kw)
        finally:
            counter.paused = False
            calls.append(kw.get("any_hit", False))

    tracking_calls = collections.Counter()
    wrapped = {}
    for name in media_tracking.launches:
        fn = wrapped[name] = getattr(media_tracking, name)

        def tracked(*args, _fn=fn, _name=name, **kw):
            counter.in_tracking = True
            try:
                return _fn(*args, **kw)
            finally:
                counter.in_tracking = False
                tracking_calls[_name] += 1
        setattr(media_tracking, name, tracked)

    renderer._isect = paused
    try:
        with torch.no_grad(), counter:
            run()
    finally:
        renderer._isect = isect
        for name, fn in wrapped.items():
            setattr(media_tracking, name, fn)
    plain = sum(c for k, c in counter.tracking.items() if k not in _VIEWS)
    return {"traversal_calls": len(calls), **counter.totals(),
            "tracking_calls": dict(tracking_calls),
            "tracking_plain_non_view_ops": plain}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene")
    ap.add_argument("--resolution", default="32x32")
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--spectral", action="store_true")
    a = ap.parse_args(argv)
    w, h = (int(x) for x in a.resolution.lower().split("x"))
    sc = with_resolution(flatten(parse_file(a.scene),
                                 os.path.dirname(a.scene)), w, h)
    if a.depth is not None:
        sc = dataclasses.replace(sc, integrator=dataclasses.replace(
            sc.integrator, max_depth=a.depth))
    r = Renderer(sc, device="cpu", spectral=a.spectral)
    print(json.dumps({"scene": a.scene, "resolution": [w, h],
                      "batches": r.n_batches,
                      "mat_features": sorted(r.st.mat_features),
                      "sampler": sc.sampler.name, **count_sample(r)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
