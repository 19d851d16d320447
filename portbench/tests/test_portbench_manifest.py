"""BENCHMARK.json against the benchmark's contract, and the harness finding
every cell's parts by name, a new cell's included."""

import json
import os
import re
import shutil

import _paths  # noqa: F401
import pytest

from harness import manifest

ROOT = _paths.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load(ROOT)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_lines(bench):
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(m["source"] in SOURCES for m in metrics)
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], ROOT, bench)
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e


def test_parts_found_by_name(bench):
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"], ROOT, bench)
        assert cell["config"]["name"] == w["config"]
        kind = manifest.kind(cell["mix"]["kind"], ROOT)
        assert callable(kind.run) and callable(kind.calibrate)
        assert set(cell["mix"]["limits"])
        for m in cell["per_layer"]:
            assert callable(manifest.reader(m["name"], ROOT))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return root


def test_new_cell_by_new_files_only(tmp_path, bench):
    """A cell, a configuration, a mix and a per-layer metric added to a copy
    of the benchmark as new files and entries are picked up with no edit
    of a file that is there."""
    root = _copy(tmp_path)
    new = json.loads(json.dumps(bench))
    conf = dict(json.load(open(os.path.join(ROOT, bench["configs"][0]
                                            ["file"]))), name="museum-small")
    (root / "portbench" / "configs" / "museum-small.json").write_text(
        json.dumps(conf))
    mix = json.load(open(os.path.join(ROOT, "portbench", "mixes",
                                      "render-1080p.json")))
    (root / "portbench" / "mixes" / "render-720p.json").write_text(
        json.dumps(dict(mix, xres=1280, yres=720, wavefront=921600)))
    (root / "portbench" / "metrics" / "frames.py").write_text(
        "def read(ctx):\n    return 7.0\n")
    new["configs"].append({"name": "museum-small", "source": "a source",
                           "file": "portbench/configs/museum-small.json",
                           "reduced": [], "why": "a why"})
    new["workloads"].append({"name": "museum-small.render-720p",
                             "config": "museum-small",
                             "traffic": "render-720p", "chips": 1,
                             "why": "a why"})
    new["per_layer"].append({"name": "frames", "unit": "frames",
                             "better": "higher", "source": "program_counter",
                             "layer": "film", "moves": "setup_s",
                             "workloads": ["museum-small.render-720p"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.cell("museum-small.render-720p", str(root))
    assert cell["mix"]["xres"] == 1280
    assert cell["config"]["name"] == "museum-small"
    names = [m["name"] for m in cell["per_layer"]]
    assert "frames" in names
    assert manifest.reader("frames", str(root))({}) == 7.0
    assert manifest.kind("render", str(root)).run
    with pytest.raises(KeyError):
        manifest.cell("no-such-cell", str(root))


KIND = """
def run(cell, seed, seconds, traced, device):
    mix = cell["mix"]
    return dict(setup_end=0.0, units=mix["frames"], peak=0,
                numbers={"frame_gap": 0.0},
                e2e={"frames_per_s": mix["frames"] / 2.0},
                ctx=dict(kind="preview", trace=None, spans={}))


def calibrate(cell, seed, device, samples):
    return {"control": {"frame_gap": 1.0}}
"""


@pytest.mark.parametrize("traced", [False, True])
def test_new_kind_by_new_files_only(tmp_path, bench, traced):
    """A kind of traffic with its own driver, check and end-to-end metric,
    added as new files and entries, runs through the harness's one
    driver with no edit of a file that is there."""
    import time

    from harness import compare, drive

    root = _copy(tmp_path)
    (root / "portbench" / "kinds" / "preview.py").write_text(KIND)
    (root / "portbench" / "mixes" / "preview-512.json").write_text(
        json.dumps({"kind": "preview", "frames": 4,
                    "limits": {"frame_gap": 0.0}}))
    (root / "portbench" / "metrics" / "frame_layer.py").write_text(
        "def read(ctx):\n    return 3.0 if ctx['kind'] == 'preview' "
        "else None\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "museum-preview-512",
                             "config": bench["configs"][0]["name"],
                             "traffic": "preview-512", "chips": 1,
                             "why": "a why"})
    new["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["museum-preview-512"]})
    new["per_layer"].append({"name": "frame_layer", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "film", "moves": "frames_per_s",
                             "workloads": ["museum-preview-512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = manifest.cell("museum-preview-512", str(root))
    out = drive.run(cell, 2**40 + 1, 1.0, traced, "cpu", time.time())
    assert out["correct"] and out["attempted"] == 4
    if traced:
        assert out["metrics"]["frame_layer"]["value"] == 3.0
    else:
        assert out["metrics"]["frames_per_s"]["value"] == 2.0
        assert set(out["metrics"]) == {"frames_per_s", "setup_s",
                                       "peak_alloc_gb"}
    assert out["checks"] == {"frame_gap": {"value": 0.0, "limit": 0.0}}
    calib = manifest.kind("preview", str(root)).calibrate(cell, 1, "cpu", 0)
    assert not compare.judge(calib["control"], cell["mix"]["limits"])[0]
