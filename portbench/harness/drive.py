"""The one general runner: it finds the kind of a cell's traffic mix by
name (`portbench/kinds/<kind>.py`, the mix's `kind`), lets it run the
program (tpupt_torch) through set-up, the timed window and the check
against the plain reference, then judges the check's numbers against the
mix's limits, reads the per-layer metrics (`portbench/metrics/<name>.py`)
and puts the result line together.

A kind's `run(cell, seed, seconds, traced, device)` returns `setup_end`
(host time at the window's start), `units` (samples or steps in the
window), `peak` (device bytes), `numbers` (the check's), `e2e` (its
end-to-end values besides `setup_s` and `peak_alloc_gb`) and `ctx` (what
the per-layer readers take: `kind`, `trace`, `spans`, ...)."""

from __future__ import annotations

import torch

from harness import compare, manifest


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """One run of a cell: the result line's fields, and the checks."""
    mix, root = cell["mix"], cell["root"]
    dev = torch.device(device)
    out = manifest.kind(mix["kind"], root).run(cell, seed, seconds, traced,
                                               dev)
    correct, checks = compare.judge(out["numbers"], mix["limits"])
    ctx = out["ctx"]
    metrics = {}
    if traced:
        for m in cell["per_layer"]:
            v = manifest.reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_end"] - t_start,
                   peak_alloc_gb=out["peak"] / 1e9)
        for m in cell["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=cell["chips"], memory_peak_bytes=out["peak"])
    result = dict(correct=correct, attempted=out["units"], failed=0,
                  metrics=metrics, device=device_info)
    tr = ctx.get("trace")
    if traced and tr and tr.get("kernels") is not None:
        device_info.update(busy_s=tr["busy_s"], window_s=tr["wall_s"])
        result["breakdown"] = dict(device_ops=tr["device_ops"],
                                   idle_gaps=tr["idle_gaps"])
    result["checks"] = checks
    return result
