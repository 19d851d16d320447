"""Structured logging, program spans and profiler glue.

Counterpart of the reference's glog logging (error.cpp Info / Warning /
Error with severity levels) and its SIGPROF sampling profiler (stats.cpp:222
ReportProfilerResults). On the card the device time is already split by
kernel, so the sampling profiler becomes `torch.profiler`: `profile_to(dir)`
writes a Chrome / Perfetto trace of the host and the device around a render,
with the program's spans on a track of their own.

Spans. `annotate(name)` opens a span at a layer boundary of the program
(`render.sample`, `path_li`, `traverse`, `grad.backward`, `upload.bvh`,
...). While recording is off, which is the default, it returns one shared
object that does nothing: no clock is read, nothing is allocated and
nothing of torch is called. `start()` turns recording on; each span then
appends a `Span` to a list in memory, which `spans()` reads and `clear()`
empties. A span never synchronises, reads a device value or launches
anything: its times are the host's enqueue times. Its clock is
`time.time_ns()`, the Unix-epoch clock on which the profiler stamps its
events (`prof.profiler.kineto_results.trace_start_ns()` and each event's
`start_ns()`), so device time can be put down to spans afterwards from a
trace taken without host operators.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import NamedTuple, Optional

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}
_state = {"level": 20, "file": None, "t0": time.time()}


def set_level(name: str):
    _state["level"] = _LEVELS.get(name.lower(), 20)


def set_logfile(path: str):
    _state["file"] = open(path, "a")


def _emit(level: str, msg: str):
    if _LEVELS[level] < _state["level"]:
        return
    line = (f"[{time.time() - _state['t0']:9.3f}s "
            f"{level.upper():7s}] {msg}")
    out = _state["file"] or sys.stderr
    print(line, file=out, flush=True)


def debug(msg):
    _emit("debug", msg)


def info(msg):
    _emit("info", msg)


def warning(msg):
    _emit("warning", msg)


def error(msg):
    _emit("error", msg)


class Span(NamedTuple):
    """One recorded span. `id` counts from 1 in the process; `parent` is
    the id of the span it was opened in on the same thread (0 at the top);
    `unit` is the sample index of a render sample or of a training step,
    shared by every span inside it; `thread` is the native thread id, as
    the profiler gives it; `count` and `kind` are the host-known counts
    the caller attached (lanes of a traversal call and its kernel, batches
    of a sample, depth of a bounce, ...)."""
    name: str
    id: int
    parent: int
    unit: Optional[int]
    thread: int
    start_ns: int
    end_ns: int
    count: Optional[int]
    kind: Optional[str]


class _Off:
    """What `annotate` returns while recording is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Recorder:
    """The spans of this process: the flag, the finished spans, and each
    thread's stack of open ones."""

    def __init__(self):
        self.on = False
        self.done = []
        self.ids = itertools.count(1)
        self.local = threading.local()

    def stack(self) -> list:
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_REC = _Recorder()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "unit", "count", "kind", "id", "parent", "start")

    def __init__(self, name, unit, count, kind):
        self.name, self.unit, self.kind = name, unit, kind
        # a tensor stands for its leading size, a host-known count
        self.count = (count if count is None or isinstance(count, int)
                      else int(count.shape[0]))

    def __enter__(self):
        stack = _REC.stack()
        up = stack[-1] if stack else None
        if self.unit is None and up is not None:
            self.unit = up.unit
        self.id = next(_REC.ids)
        self.parent = up.id if up is not None else 0
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.time_ns()
        _REC.stack().pop()
        _REC.done.append(Span(self.name, self.id, self.parent, self.unit,
                              threading.get_native_id(), self.start, end,
                              self.count, self.kind))
        return False


def annotate(name: str, unit: int = None, count=None, kind: str = None):
    """A span named `name` around a `with` block: the program's phase
    marker. `unit` sets the unit id (else the enclosing span's is kept);
    `count` (an int, or a tensor whose leading size is the count) and
    `kind` are host-known counts kept with it. With recording off this is
    one flag check."""
    if not _REC.on:
        return _OFF
    return _Open(name, unit, count, kind)


def start():
    """Turn span recording on."""
    _REC.on = True


def stop():
    """Turn span recording off (spans already open still finish)."""
    _REC.on = False


def recording() -> bool:
    return _REC.on


def spans() -> list:
    """The finished spans, in the order they started."""
    return sorted(_REC.done, key=lambda s: (s.start_ns, s.id))


def clear():
    """Forget the finished spans."""
    _REC.done.clear()


SPAN_TRACK = 1 << 30  # the pid of the spans' track in profile_to's trace


def _chrome_events(recorded, base_ns: int) -> list:
    """`recorded` spans as Chrome trace events on their own track (pid
    SPAN_TRACK, one row a thread), `base_ns` being the trace's
    `baseTimeNanoseconds`."""
    out = [dict(ph="M", name="process_name", pid=SPAN_TRACK, tid=0,
                args=dict(name="tpupt_torch spans"))]
    for s in recorded:
        args = dict(id=s.id, parent=s.parent)
        for k in ("unit", "count", "kind"):
            if getattr(s, k) is not None:
                args[k] = getattr(s, k)
        out.append(dict(ph="X", cat="span", name=s.name, pid=SPAN_TRACK,
                        tid=s.thread, ts=(s.start_ns - base_ns) / 1e3,
                        dur=(s.end_ns - s.start_ns) / 1e3, args=args))
    return out


@contextlib.contextmanager
def profile_to(trace_dir: str):
    """Collect a torch.profiler trace (host, and the CUDA device when there
    is one) into `trace_dir`/trace.json, for ui.perfetto.dev or
    chrome://tracing: the kernels' device lanes stand in for the reference's
    per-category SIGPROF histogram, and the program's spans of the region
    (recorded for it) lie on a track of their own beside them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    info(f"profiler: tracing to {trace_dir}")
    was_on, n0 = recording(), len(_REC.done)
    start()
    t0 = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            stop()
    region = sorted((s for s in _REC.done[n0:] if s.start_ns >= t0),
                    key=lambda s: (s.start_ns, s.id))
    if not was_on:  # recorded for the trace alone
        del _REC.done[n0:]
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += _chrome_events(
        region, int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
    info(f"profiler: trace written to {path}")
