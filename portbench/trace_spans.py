"""A run of a cell with the program's own spans recorded from its start:

    python3 portbench/trace_spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout. The cell runs as `portbench/run.py --trace 1`
runs it (set-up, the timed window, the traced stretch under the profiler,
the check against the reference), with span recording
(tpupt_torch/utils/logging.py) on throughout. The window runs with spans on
and the profiler off, so its host times are the program's own and its
end-to-end value, held against an untraced run of the same seed, is what
recording costs; the traced stretch runs with both, and its device time is
put down to the span that launched it (harness/spans.py).

Prints one JSON line: `correct` and `checks` as run.py gives them, the
window's end-to-end values, `metrics` (the cell's per-layer readers and the
span readers `shading_host_ms_per_spp`, `pass2_host_ms_per_step`,
`backward_device_share`, `bvh_build_s`, `treelets_s`, `flatten_s`, each
where it finds something to read), `attributed_share` (the traced device
time put down to some span), own host ms of each span name a window unit,
device ms of each a traced unit (both also by stage: a step's passes, a
sample's bounces), the idle gaps of the traced stretch by
span, and the host-known counts a window unit. The idle gaps are also
printed as a table on standard error. Exits 2 without a card or where the
program records no spans."""

import time

T_START = time.time()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

# the stages a unit's time is also summed by: a training step's passes; a
# sample's camera, bounces (by depth, their traversal calls included), film
STAGES = {
    "inverse": lambda s: s.name if s.name.startswith("grad.") else None,
    "render": lambda s: (f"bounce.{s.count}" if s.name == "bounce" else None
                         if s.name in ("traverse", "shade", "nee", "bsdf",
                                       "continue") else s.name)}
SPAN_METRICS = ("shading_host_ms_per_spp", "pass2_host_ms_per_step",
                "backward_device_share", "bvh_build_s", "treelets_s",
                "flatten_s")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    return p.parse_args(argv)


def counts(tree, units) -> dict:
    """Host-known counts a unit: traversal calls and lanes by kernel,
    batches (pass 1's and pass 2's in a training step), bounces and
    backward calls."""
    c = collections.Counter()
    for u in units:
        for s in tree.descendants(u):
            if s.name == "traverse":
                c[f"traverse_calls.{s.kind}"] += 1
                c[f"traverse_lanes.{s.kind}"] += s.count or 0
            elif s.name in ("render.batch", "bounce", "grad.backward"):
                c[s.name] += 1
    return {k: v / max(len(units), 1) for k, v in sorted(c.items())}


def report(cell, out, recorded, prof) -> dict:
    """What the run's spans and its trace give, as the JSON line's fields."""
    from harness import manifest, spans

    tree = spans.Tree(recorded)
    events = spans.device_events(prof)
    t_trace = prof.profiler.kineto_results.trace_start_ns()
    by_id = spans.attribute(events, tree)
    ctx = dict(out["ctx"], program_spans=recorded,
               window_ns=(int(out["setup_end"] * 1e9), t_trace))
    ctx["trace"] = dict(ctx["trace"], span_device_ns=by_id, start_ns=t_trace)
    metrics = {}
    for name in [m["name"] for m in cell["per_layer"]] + list(SPAN_METRICS):
        v = manifest.reader(name, cell["root"])(ctx)
        if v is not None:
            metrics[name] = v
    window = spans.window_units(ctx, tree)
    n_traced = cell["mix"]["trace_units"]
    total = sum(by_id.values())
    builds = tree.named("build.nvcc")
    own, stage = spans.own_ns(tree, window), STAGES[ctx["kind"]]
    return dict(
        metrics=metrics,
        window_units=len(window),
        attributed_share=(total - by_id.get(0, 0)) / total if total else None,
        host_ms_by_span=spans.group_ms(tree, own, len(window)),
        device_ms_by_span=spans.group_ms(tree, by_id, n_traced),
        host_ms_by_stage=spans.group_ms(tree, own, len(window), stage),
        device_ms_by_stage=spans.group_ms(tree, by_id, n_traced, stage),
        idle_gaps_by_span=spans.idle_gaps_by_span(events, tree),
        idle_gaps=ctx["trace"].get("idle_gaps"),
        counts=dict(counts(tree, window), builds=len(builds),
                    build_s=sum(s.end_ns - s.start_ns for s in builds) / 1e9),
        setup_spans_s={n: spans.setup_seconds(ctx, n) for n in (
            "scene.parse", "scene.flatten", "upload", "upload.tables",
            "upload.bvh", "upload.treelets", "upload.copy")})


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from harness import compare, manifest, spans, trace

    cell = manifest.cell(args.workload)
    tlog = spans.recorder()
    if not torch.cuda.is_available() or tlog is None:
        print(f"{args.workload}: needs a CUDA device and a program that "
              "records spans", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profs, make = [], trace.profiler

    def profiler():            # keeps the traced stretch's profiler
        p = make()
        profs.append(p)
        return p

    trace.profiler = profiler
    tlog.start()
    out = manifest.kind(cell["mix"]["kind"], cell["root"]).run(
        cell, args.seed, args.seconds, True, torch.device("cuda"))
    tlog.stop()
    correct, checks = compare.judge(out["numbers"], cell["mix"]["limits"])
    rep = report(cell, out, tlog.spans(), profs[0])
    result = dict(workload=args.workload, seed=args.seed, correct=correct,
                  attempted=out["units"], e2e=out["e2e"],
                  setup_s=out["setup_end"] - T_START,
                  peak_alloc_gb=out["peak"] / 1e9,
                  device=torch.cuda.get_device_name(0), **rep, checks=checks)
    print("idle gaps of the traced stretch by the innermost span at their "
          "middle (s):", file=sys.stderr)
    for name, s in rep["idle_gaps_by_span"]:
        print(f"  {name:<16} {s:.6f}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
