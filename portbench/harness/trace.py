"""Reading a torch.profiler trace of a stretch of the timed path: device
intervals, their union (busy time), launches, device time by kernel, and
the idle gaps between device work labelled by what the host was doing.

`device_rows` is a frozen copy of `chip_smoke.py` `device_rows`
(lines 2233-2244) at commit 2f1d965."""

from __future__ import annotations

import bisect
import collections

import torch

TRAVERSAL_MARK = "traverse_"


def profiler():
    """A profiler of the device's work and the CUDA runtime calls that
    launch it. Host operators are not recorded: recording each one made a
    traced training step 15x as long as an untraced one."""
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        return profile(activities=[ProfilerActivity.CUDA])
    return profile(activities=[ProfilerActivity.CPU])


def device_rows(prof):
    """(kernel name, device ms, launches) of a torch.profiler run, longest
    first. Kernel rows only: the profiler also credits each kernel's time to
    the operator that launched it, and summing both would count it twice."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        on_device = str(getattr(e, "device_type", "")).upper().endswith("CUDA")
        if dev_us > 0 and on_device:
            rows.append((e.key, dev_us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).upper().endswith("CUDA")


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit / 1e6."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def idle_gaps(intervals, host_ops, top: int = 10):
    """The idle gaps between merged device intervals, their seconds summed
    by the innermost host operation running at each gap's middle ("python"
    where none is), longest first."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ops = sorted(host_ops, key=lambda r: r[1])
    starts = [r[1] for r in ops]
    by = collections.Counter()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 32, -1), -1):
            if ops[j][2] >= mid:
                label = ops[j][0]
                break
        by[label] += (s1 - e0) / 1e6
    return [[k, v] for k, v in by.most_common(top)]


def summarize(prof, wall_s: float, units: int) -> dict:
    """What the per-layer readers take from a traced stretch of `units`
    samples or steps that lasted `wall_s` on the host clock. `kernels` is
    None where the trace holds no device work (no card)."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if _is_device(e):
            dev.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    if not dev:
        return dict(kernels=None, units=units, wall_s=wall_s)
    intervals = [(s, e) for _, s, e in dev]
    return dict(
        kernels=[(n, (e - s) / 1e6) for n, s, e in dev],
        launches=len(dev), busy_s=union_seconds(intervals), wall_s=wall_s,
        units=units,
        device_ops=[[k[:120], ms / 1e3]
                    for k, ms, _ in device_rows(prof)[:10]],
        idle_gaps=idle_gaps(intervals, host))


def kernel_seconds(prof, mark: str) -> tuple:
    """(seconds, launches) of the device work whose name holds `mark`."""
    secs, n = 0.0, 0
    for e in prof.events():
        if _is_device(e) and mark in e.name:
            secs += (e.time_range.end - e.time_range.start) / 1e6
            n += 1
    return secs, n
