"""The span readers and harness/spans.py on synthetic spans and device
events: innermost spans, device time put down by the launch's time (a
launch on autograd's thread inside `grad.backward` included), idle gaps by
span, own host times, and nothing read where the program recorded no
spans."""

import _paths  # noqa: F401
import pytest

from harness import manifest, spans
from tpupt_torch.utils.logging import Span

MS = 1_000_000
MAIN, AUTOGRAD = 11, 12


def _read(name, ctx):
    return manifest.reader(name, _paths.ROOT)(ctx)


def _span(name, id, parent, start, end, unit=None, count=None, kind=None,
          thread=MAIN):
    return Span(name, id, parent, unit, thread, start * MS, end * MS, count,
                kind)


def _render_spans():
    """Set-up, then two samples (0 in set-up, 1 in the window), each one
    batch of one bounce: 10 ms of bounce, 4 of it the closest hit and 2
    the shadow ray."""
    out = [_span("scene.flatten", 1, 0, 0, 3),
           _span("upload", 2, 0, 3, 20),
           _span("upload.tables", 3, 2, 3, 19),
           _span("upload.bvh", 4, 3, 4, 12),
           _span("upload.treelets", 5, 3, 13, 18),
           _span("upload.copy", 6, 2, 19, 20)]
    sid = 7
    for unit, t0 in ((0, 30), (1, 100)):
        s = [("render.sample", 0, 0, 20), ("render.batch", 1, 0, 20),
             ("camera", 2, 0, 2), ("path_li", 2, 2, 14),
             ("bounce", 4, 2, 12), ("traverse", 5, 2, 6),
             ("shade", 5, 6, 8), ("nee", 5, 8, 11), ("traverse", 8, 8, 10),
             ("bsdf", 5, 11, 12), ("film", 2, 14, 18)]
        base = sid
        for name, up, a, b in s:
            parent = 0 if up == 0 else base + up - 1
            out.append(_span(name, sid, parent, t0 + a, t0 + b, unit=unit))
            sid += 1
    return out


def _render_ctx(**kw):
    ctx = dict(kind="render", trace=None, k3=None, spans={},
               program_spans=_render_spans(), window_ns=(90 * MS, 200 * MS))
    ctx.update(kw)
    return ctx


def test_setup_readers():
    ctx = _render_ctx()
    assert _read("bvh_build_s", ctx) == pytest.approx(8e-3)
    assert _read("treelets_s", ctx) == pytest.approx(5e-3)
    assert _read("flatten_s", ctx) == pytest.approx(3e-3)
    single = [s for s in ctx["program_spans"] if s.name != "upload.treelets"]
    assert _read("treelets_s", _render_ctx(program_spans=single)) is None


def test_shading_host_ms_per_spp_takes_the_window_alone():
    # the window holds sample 1 only: 10 ms of bounce less 4 + 2 of traverse
    assert _read("shading_host_ms_per_spp", _render_ctx()) == \
        pytest.approx(4.0)
    both = _render_ctx(window_ns=(0, 200 * MS))
    assert _read("shading_host_ms_per_spp", both) == pytest.approx(4.0)
    assert _read("pass2_host_ms_per_step", _render_ctx()) is None


def _grad_ctx():
    """One training step in the window (0-100 ms) and one traced (200-300
    ms), whose backward's kernels are launched on autograd's thread."""
    out, sid = [], 1
    for unit, t0 in ((3, 0), (4, 200)):
        for name, up, a, b in (("grad.step", 0, 0, 100),
                               ("grad.pass1", 1, 0, 40),
                               ("grad.loss", 1, 40, 45),
                               ("grad.pass2", 1, 45, 95),
                               ("grad.replay", 4, 45, 70),
                               ("grad.backward", 4, 70, 94)):
            parent = 0 if up == 0 else [s for s in out
                                        if s.unit == unit][up - 1].id
            out.append(_span(name, sid, parent, t0 + a, t0 + b, unit=unit))
            sid += 1
    tree = spans.Tree(out)
    events = [  # (name, start, end, launch) in ns
        ("pass1_kernel", 210 * MS, 215 * MS, 205 * MS),
        ("replay_kernel", 250 * MS, 251 * MS, 246 * MS),
        ("backward_kernel", 272 * MS, 278 * MS, 271 * MS),   # autograd's
        ("backward_kernel", 280 * MS, 282 * MS, 279 * MS),   # thread, by time
        ("sync_copy", 296 * MS, 297 * MS, 296 * MS),         # grad.step
        ("stray", 299 * MS, 300 * MS, None)]                 # no launch
    by_id = spans.attribute(events, tree)
    return dict(kind="inverse", trace=dict(span_device_ns=by_id,
                                           start_ns=200 * MS),
                k3=None, spans={}, program_spans=out,
                window_ns=(0, 200 * MS)), tree, events


def test_attribution_by_launch_time():
    ctx, tree, events = _grad_ctx()
    by_id = ctx["trace"]["span_device_ns"]
    assert spans.group_ms(tree, by_id, 1) == pytest.approx(
        {"grad.backward": 8.0, "grad.pass1": 5.0, "grad.replay": 1.0,
         "grad.step": 1.0, spans.OUTSIDE: 1.0})
    passes = spans.group_ms(tree, by_id, 2, lambda s: (
        "pass2" if s.name == "grad.pass2" else None))
    assert passes == pytest.approx({"pass2": 4.5, spans.OUTSIDE: 3.5})
    assert _read("backward_device_share", ctx) == pytest.approx(50.0)
    assert _read("pass2_host_ms_per_step", ctx) == pytest.approx(50.0)
    assert _read("shading_host_ms_per_spp", ctx) is None


def test_innermost_across_threads():
    main = [_span("grad.pass2", 1, 0, 0, 100),
            _span("grad.backward", 2, 1, 10, 90)]
    worker = [_span("hook", 3, 0, 20, 30, thread=AUTOGRAD)]
    tree = spans.Tree(main + worker)
    assert tree.innermost(5 * MS).name == "grad.pass2"
    assert tree.innermost(15 * MS).name == "grad.backward"
    # the deepest span holding the time wins, whatever its thread
    assert tree.innermost(25 * MS).name == "grad.backward"
    assert tree.innermost(95 * MS).name == "grad.pass2"
    assert tree.innermost(150 * MS) is None and tree.innermost(None) is None


def test_idle_gaps_and_own_time():
    ctx, tree, events = _grad_ctx()
    gaps = dict(spans.idle_gaps_by_span(events, tree))
    # gaps 215-250 ms (middle in pass 1), 251-272 (replay), 278-280 and
    # 282-296 (backward), 297-299 (the step itself)
    assert gaps["grad.pass1"] == pytest.approx(0.035)
    assert gaps["grad.replay"] == pytest.approx(0.021)
    assert gaps["grad.backward"] == pytest.approx(0.002 + 0.014)
    assert gaps["grad.step"] == pytest.approx(0.002)
    assert len(gaps) == 4
    (step,) = spans.window_units(ctx, tree)
    assert spans.self_ns(tree, step) == 5 * MS
    own = spans.group_ms(tree, spans.own_ns(tree, [step]), 1)
    assert own["grad.pass2"] == pytest.approx(1.0)
    assert own["grad.backward"] == pytest.approx(24.0)
    assert sum(own.values()) == pytest.approx(100.0)


def test_no_spans_no_reading():
    for kind in ("render", "inverse"):
        ctx = dict(kind=kind, trace=dict(kernels=None, units=1, wall_s=1.0),
                   k3=None, spans={})
        for name in ("shading_host_ms_per_spp", "pass2_host_ms_per_step",
                     "backward_device_share", "bvh_build_s", "treelets_s",
                     "flatten_s"):
            assert _read(name, ctx) is None
        ctx["program_spans"] = []
        assert _read("flatten_s", ctx) is None
