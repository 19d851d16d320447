"""The port's span recorder (tpupt_torch/utils/logging.py): the span tree of
one rendered sample and of one training step, what recording off costs
(nothing recorded, no clock read, no object made, the same torch
operations dispatched), the shared clock with the profiler, and the spans
in profile_to's trace. On a 12x12 scene in one 144-lane batch: each case
takes about a second or less."""

import json
import threading

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.utils import logging as tlog

torch.set_num_threads(1)

MAX_DEPTH = 1
_SCENE = """
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "halton" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [%d]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "color L" [6 6 6]
  Translate 0 2.2 0
  Shape "trianglemesh" "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 0 0.6  -0.6 0 0.6]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "sphere" "float radius" [0.7]
Shape "trianglemesh" "point P" [-5 -1 -5  5 -1 -5  5 -1 5  -5 -1 5]
    "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


@pytest.fixture
def recorder():
    """Recording on, for one test; off and empty afterwards."""
    tlog.clear()
    tlog.start()
    yield tlog
    tlog.stop()
    tlog.clear()


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    """The scene file at depth MAX_DEPTH, and at depth 0 (one bounce: half
    the operations, for the dispatch count)."""
    def write(depth):
        path = tmp_path_factory.mktemp("spans") / f"depth{depth}.pbrt"
        path.write_text(_SCENE % depth)
        return str(path)
    return write


def _children(recorded):
    kids = {}
    for s in recorded:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _names(spans_):
    return [s.name for s in spans_]


def _renderer(scene_path):
    r = Renderer(flatten(parse_file(scene_path)), device="cpu")
    r.set_batch(144)     # one batch of the 144 pixels
    return r


def test_span_tree_of_a_sample_and_a_step(recorder, scene_path):
    r = _renderer(scene_path(MAX_DEPTH))
    r._spp(r.new_film(), 3)
    r.value_and_grad(lambda f: f.rgb.sum(), {"light_L": r.ds.light_L},
                     sample_idx=7)
    recorded = tlog.spans()
    kids = _children(recorded)
    top = kids[0]
    assert _names(top) == ["scene.parse", "scene.flatten", "upload",
                           "render.sample", "grad.step"]
    upload = top[2]
    assert _names(kids[upload.id]) == ["upload.tables", "upload.copy"]
    assert _names(kids[kids[upload.id][0].id]) == ["upload.bvh"]

    def check_batch(batch, unit, kind):
        assert _names(kids[batch.id]) == ["camera", "path_li", "film"]
        bounces = kids[kids[batch.id][1].id]
        assert _names(bounces) == ["bounce"] * (MAX_DEPTH + 1)
        assert [b.count for b in bounces] == list(range(MAX_DEPTH + 1))
        for b in bounces:
            assert _names(kids[b.id]) == ["traverse", "shade", "nee",
                                          "bsdf", "continue"]
            shadow = kids[kids[b.id][2].id]
            assert _names(shadow) == ["traverse"]
            for t in (kids[b.id][0], shadow[0]):
                assert (t.kind, t.count) == (kind, r.batch)
        inside = [batch]
        while inside:
            s = inside.pop()
            assert s.unit == unit and s.start_ns <= s.end_ns
            inside += kids.get(s.id, [])

    sample = top[3]
    assert (sample.unit, sample.count) == (3, r.n_batches)
    assert _names(kids[sample.id]) == ["render.batch"] * r.n_batches
    check_batch(kids[sample.id][0], 3, "K1")

    step = top[4]
    assert step.unit == 7
    pass1, loss, pass2 = kids[step.id]
    assert _names([pass1, loss, pass2]) == ["grad.pass1", "grad.loss",
                                            "grad.pass2"]
    check_batch(kids[pass1.id][0], 7, "K1")
    assert _names(kids[pass2.id]) == ["grad.replay",
                                      "grad.backward"] * r.n_batches
    replay, backward = kids[pass2.id][:2]
    check_batch(kids[replay.id][0], 7, "replay")
    assert pass2.start_ns <= backward.start_ns <= backward.end_ns \
        <= pass2.end_ns and backward.unit == 7


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_recording_off_costs_nothing_and_dispatches_the_same(scene_path,
                                                             monkeypatch):
    r = _renderer(scene_path(0))
    tlog.clear()
    assert not tlog.recording()
    # off: one shared object whatever the span; no span is made, so no
    # clock is read
    assert tlog.annotate("a") is tlog.annotate("traverse", 1, 5, "K3")

    def no_span(*args):
        raise AssertionError("a span was made while recording is off")
    monkeypatch.setattr(tlog, "_Open", no_span)
    with _Count() as off:
        film_off = r._spp(r.new_film(), 0)
    assert tlog.spans() == []
    monkeypatch.undo()
    tlog.start()
    try:
        with _Count() as on:
            film_on = r._spp(r.new_film(), 0)
    finally:
        tlog.stop()
    assert len(tlog.spans()) > 10
    tlog.clear()
    assert off.ops == on.ops and len(off.ops) > 100
    assert torch.equal(film_off.rgb, film_on.rgb)


def test_a_span_holds_its_operator_on_the_profilers_clock(recorder):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tlog.annotate("matmul", unit=1):
            x @ x
    (span,) = tlog.spans()
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert span.start_ns <= mm[0].start_ns() <= mm[0].end_ns() \
        <= span.end_ns


def test_threads_keep_their_own_nesting(recorder):
    def other():
        with tlog.annotate("worker", unit=2):
            with tlog.annotate("inner"):
                pass

    with tlog.annotate("main", unit=1):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    by = {s.name: s for s in tlog.spans()}
    assert by["worker"].parent == 0 and by["worker"].unit == 2
    assert by["inner"].parent == by["worker"].id and by["inner"].unit == 2
    assert by["main"].parent == 0 and by["main"].thread != by["inner"].thread


def test_profile_to_writes_the_spans_on_their_own_track(tmp_path):
    tlog.clear()
    x = torch.randn(32, 32)
    with tlog.profile_to(str(tmp_path)):
        with tlog.annotate("render.sample", unit=0, count=1):
            x @ x
    assert not tlog.recording() and tlog.spans() == []
    trace = json.loads((tmp_path / "trace.json").read_text())
    ev = trace["traceEvents"]
    (span,) = [e for e in ev if e.get("cat") == "span"]
    assert span["pid"] == tlog.SPAN_TRACK and span["name"] == "render.sample"
    assert span["args"]["unit"] == 0 and span["args"]["count"] == 1
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    assert mm and span["ts"] <= mm[0]["ts"] <= mm[0]["ts"] + mm[0]["dur"] \
        <= span["ts"] + span["dur"]
    assert any(e.get("pid") == tlog.SPAN_TRACK and e.get("ph") == "M"
               for e in ev)
