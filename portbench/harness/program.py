"""What every kind of traffic shares: the system under test set up for a
cell (parse, flatten, upload), the reference's scene and tree, the timed
window and the traced stretch after it, and the run's progress log."""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

from harness import scenes, trace


def log(msg: str) -> None:
    """A line of the run's progress on standard error."""
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seed_of(seed: int) -> int:
    """The run's seed as a torch and sampler seed (any whole number)."""
    return int(seed) % (1 << 63)


def free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


class Program:
    """The system under test (tpupt_torch), set up for one cell: parse,
    flatten and upload into a `Renderer` whose wavefront is the mix's, with
    the host seconds of the load and of the upload."""

    def __init__(self, cell: dict, seed: int, device):
        from tpupt_torch.integrators.path import Renderer
        from tpupt_torch.scene.flatten import flatten
        from tpupt_torch.scene.loader import parse_file

        mix = cell["mix"]
        pbrt = scenes.pbrt_file(cell["config"], mix["xres"], mix["yres"])
        t0 = time.perf_counter()
        sc = flatten(parse_file(pbrt), os.path.dirname(pbrt))
        self.scene_load_s = time.perf_counter() - t0
        sc.sampler.seed = seed_of(seed)
        self.renderer = Renderer(sc, device=device)
        self.upload_s = self.renderer.upload_seconds
        self.renderer.set_batch(mix["wavefront"])
        self.device = self.renderer.device

    def spans(self) -> dict:
        return dict(scene_load_s=self.scene_load_s, upload_s=self.upload_s)


def reference_scene(cell: dict, seed: int, device):
    """The reference's own scene (from the generator's plain arrays, its
    sampler seeded by the run's seed) and its tree."""
    from reference import bvh
    from reference import scene as rscene

    mix = cell["mix"]
    desc = scenes.reference_scene(cell["config"], mix["xres"], mix["yres"])
    sc = rscene.build(desc, seed_of(seed), device)
    return sc, bvh.build(sc.p0, sc.p1, sc.p2)


def window(unit, seconds: float, dev) -> dict:
    """Calls `unit(i)` for i = 0, 1, ... until `seconds` have passed on
    the host clock, each call ended by a device sync. Python's collector is
    emptied and frozen first, so that the objects of set-up are not walked
    again inside the window. Returns the units done, the seconds they took
    and each unit's seconds."""
    gc.collect()
    gc.freeze()
    n, times = 0, []
    t0 = time.perf_counter()
    while True:
        unit(n)
        n += 1
        sync(dev)
        times.append(time.perf_counter())
        if times[-1] - t0 >= seconds:
            break
    each = [b - a for a, b in zip([t0] + times, times)]
    return dict(units=n, elapsed=times[-1] - t0, each=each)


def traced(unit, first: int, count: int, dev) -> dict:
    """`count` more units from `first` under the profiler (after the
    window, so that no unit of the window pays for the profiler, which
    slows even later launches); the trace's summary."""
    t0 = time.perf_counter()
    with trace.profiler() as prof:
        for i in range(first, first + count):
            unit(i)
        sync(dev)
    return trace.summarize(prof, time.perf_counter() - t0, count)


def describe(win: dict, what: str) -> str:
    """The window's units and the spread of their times, for the log."""
    ms = [1e3 * x for x in win["each"]]
    q = sorted(ms)
    return (f"window: {win['units']} {what} in {win['elapsed']:.2f} s; "
            f"ms a unit: min {q[0]:.1f}, median {q[len(q) // 2]:.1f}, "
            f"max {q[-1]:.1f}; in order "
            + " ".join(f"{x:.0f}" for x in ms))
