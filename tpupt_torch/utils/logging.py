"""Structured logging and profiler glue.

Counterpart of the reference's glog logging (error.cpp Info / Warning /
Error with severity levels) and its SIGPROF sampling profiler (stats.cpp:222
ReportProfilerResults). On the card the device time is already split by
kernel, so the sampling profiler becomes `torch.profiler`: `profile_to(dir)`
writes a Chrome / Perfetto trace of the host and the device around a render,
and `annotate(name)` adds a host-side range that shows beside the device's
kernels.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

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


@contextlib.contextmanager
def profile_to(trace_dir: str):
    """Collect a torch.profiler trace (host, and the CUDA device when there
    is one) into `trace_dir`/trace.json, for ui.perfetto.dev or
    chrome://tracing: the kernels' device lanes stand in for the reference's
    per-category SIGPROF histogram."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    info(f"profiler: tracing to {trace_dir}")
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    info(f"profiler: trace written to {path}")


def annotate(name: str):
    """Host-side phase marker inside a profile_to() region."""
    from torch.profiler import record_function

    return record_function(name)
