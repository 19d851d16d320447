"""The program's own spans (tpupt_torch/utils/logging.py) read against a
profiler trace of the device.

Spans are stamped with `time.time_ns()`, the clock the profiler stamps its
events with, so each device event is put down to the innermost span whose
interval holds the host time of the runtime call that launched it (matched
by the CUPTI correlation id): by time and not by thread, since the
backward's kernels are launched from autograd's device thread while the
main thread sits in `grad.backward`. Each idle gap between device work is
put down to the innermost span at its middle.

Every function takes plain data (spans as the recorder's `Span` tuples,
device events as (name, start_ns, end_ns, launch_ns) rows), so that the
readers in portbench/metrics work on synthetic data too. A program that
records no spans (a commit before the recorder) gives None at `recorder`,
and every reader then reads nothing."""

from __future__ import annotations

import bisect
import collections

OUTSIDE = "(no span)"


def recorder():
    """The program's span recorder module, or None where it has none."""
    try:
        from tpupt_torch.utils import logging as tlog
    except ImportError:
        return None
    return tlog if hasattr(tlog, "spans") and hasattr(tlog, "start") else None


def _is_device(e) -> bool:
    return str(e.device_type()).upper().endswith("CUDA")


def device_events(prof) -> list:
    """(name, start_ns, end_ns, launch_ns) of every device event of a
    torch.profiler run, `launch_ns` being the host start of the runtime
    call that launched it (None where the trace holds no such call)."""
    launch, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if _is_device(e):
            dev.append(e)
        else:
            launch[e.correlation_id()] = e.start_ns()
    rows = []
    for e in dev:
        t = launch.get(e.correlation_id(),
                       launch.get(e.linked_correlation_id()))
        s = e.start_ns()
        rows.append((e.name(), s, s + e.duration_ns(), t))
    return rows


class Tree:
    """Spans indexed for `innermost(t)`: the deepest span whose interval
    holds host time t (ties: the one that started last)."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, s.id))
        self.by_id = {s.id: s for s in self.spans}
        self.depth, self.children = {}, collections.defaultdict(list)
        for s in self.spans:
            p = self.by_id.get(s.parent)
            self.depth[s.id] = 0 if p is None else self.depth[p.id] + 1
            if p is not None:
                self.children[p.id].append(s)
        self.threads = collections.defaultdict(list)
        for s in self.spans:
            self.threads[s.thread].append(s)
        self.thread_starts = {k: [s.start_ns for s in v]
                              for k, v in self.threads.items()}

    def innermost(self, t):
        if t is None:
            return None
        best = None
        for th, spans in self.threads.items():
            i = bisect.bisect_right(self.thread_starts[th], t) - 1
            s = spans[i] if i >= 0 else None
            # on one thread spans nest: the innermost holding t is the last
            # one started by t or an ancestor of it
            while s is not None and s.end_ns < t:
                s = self.by_id.get(s.parent)
            if s is not None and (
                    best is None or (self.depth[s.id], s.start_ns)
                    > (self.depth[best.id], best.start_ns)):
                best = s
        return best

    def named(self, name: str, t0=None, t1=None) -> list:
        """The spans `name` that lie wholly in [t0, t1]."""
        return [s for s in self.spans if s.name == name
                and (t0 is None or s.start_ns >= t0)
                and (t1 is None or s.end_ns <= t1)]

    def descendants(self, span) -> list:
        """The spans inside `span` on its thread, at any depth."""
        out, todo = [], list(self.children[span.id])
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(self.children[s.id])
        return out


def attribute(events, tree: Tree) -> dict:
    """Device ns of `events` by the id of the span each was launched in
    (0: no span held its launch)."""
    out = collections.Counter()
    for _, s, e, launch in events:
        sp = tree.innermost(launch)
        out[sp.id if sp is not None else 0] += e - s
    return dict(out)


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps_by_span(events, tree: Tree, top: int = 12) -> list:
    """The idle gaps between merged device intervals, their seconds summed
    by the innermost span at each gap's middle, longest first."""
    by = collections.Counter()
    m = merged((s, e) for _, s, e, _ in events)
    for (_, e0), (s1, _) in zip(m, m[1:]):
        sp = tree.innermost((e0 + s1) // 2)
        by[sp.name if sp is not None else OUTSIDE] += (s1 - e0) / 1e9
    return [[k, v] for k, v in by.most_common(top)]


def self_ns(tree: Tree, span) -> int:
    """`span`'s own host time: its length less its children's."""
    return (span.end_ns - span.start_ns) - sum(
        s.end_ns - s.start_ns for s in tree.children[span.id])


def own_ns(tree: Tree, units) -> dict:
    """Own host ns (`self_ns`) of every span inside the unit spans `units`,
    by span id."""
    return {s.id: self_ns(tree, s)
            for u in units for s in [u] + tree.descendants(u)}


def by_name(span):
    return span.name


def group_ms(tree: Tree, ns_by_id: dict, n_units: int, stage=by_name) -> dict:
    """`ns_by_id` (span id -> ns) in ms a unit, summed by `stage(span)` of
    each span, or of its nearest ancestor where that is None; OUTSIDE where
    no span (or id 0) gives one. Longest first."""
    out = collections.Counter()
    for sid, ns in ns_by_id.items():
        sp, label = tree.by_id.get(sid), None
        while sp is not None and label is None:
            label = stage(sp)
            sp = tree.by_id.get(sp.parent)
        out[label or OUTSIDE] += ns / 1e6 / max(n_units, 1)
    return dict(out.most_common())


def tree_of(ctx):
    """A `Tree` of the run's spans (`ctx["program_spans"]`), or None where
    the program recorded none."""
    recorded = ctx.get("program_spans")
    return Tree(recorded) if recorded else None


UNIT_SPAN = {"render": "render.sample", "inverse": "grad.step"}


def window_units(ctx, tree: Tree) -> list:
    """The unit spans (`render.sample` or `grad.step`) of the timed window:
    those between its start and the traced stretch's (`ctx["window_ns"]`)."""
    t0, t1 = ctx["window_ns"]
    return tree.named(UNIT_SPAN[ctx["kind"]], t0, t1)


def setup_seconds(ctx, name: str):
    """Host seconds of the spans `name` (set-up spans: one a run), or None
    where there are none."""
    tree = tree_of(ctx)
    found = tree.named(name) if tree else []
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9
