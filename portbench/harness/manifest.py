"""Everything the harness runs is found by name from `BENCHMARK.json`: a
cell names its configuration (a `configs[].file`) and its traffic mix
(`portbench/mixes/<traffic>.json`); the mix names its kind, whose driver,
check and end-to-end values are `portbench/kinds/<kind>.py`; each
per-layer metric that applies to the cell has a reader,
`portbench/metrics/<name>.py`. Adding a cell, a configuration, a mix, a
kind of traffic or a metric adds files and entries and edits none."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, bench: dict = None) -> dict:
    """The cell `name`: its workload entry, configuration, mix, and the
    end-to-end and per-layer metrics it reports. Raises KeyError for a
    name BENCHMARK.json does not hold."""
    bench = bench or load(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "mixes",
                           w["traffic"] + ".json")) as f:
        mix = json.load(f)
    return dict(
        workload=w, config=config, mix=mix, chips=w["chips"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root)


def _module(folder: str, name: str, root: str):
    path = os.path.join(root, "portbench", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The `read(ctx)` function of portbench/metrics/<metric>.py."""
    return _module("metrics", metric, root).read


def kind(name: str, root: str = ROOT):
    """The module portbench/kinds/<name>.py: `run` and `calibrate`."""
    return _module("kinds", name, root)
