"""The per-layer readers and the trace and roofline arithmetic, on
synthetic profiler rows."""

import _paths  # noqa: F401
import pytest

from harness import manifest, peaks, trace


def _read(name, ctx):
    return manifest.reader(name, _paths.ROOT)(ctx)


def _ctx(kind, **kw):
    kernels = [("traverse_treelets_kernel", 0.010), ("elementwise", 0.020),
               ("gather", 0.030), ("traverse_treelets_kernel", 0.010)]
    tr = dict(kernels=kernels, launches=len(kernels), busy_s=0.05,
              wall_s=2.0, units=2)
    return dict(kind=kind, trace=tr, k3=None,
                spans=dict(scene_load_s=1.5, upload_s=2.5), **kw)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40), (60, 70)]
    assert trace.union_seconds(iv) == pytest.approx(40e-6)
    host = [("cudaLaunchKernel", 21, 29), ("cudaStreamSynchronize", 40, 65)]
    gaps = dict(trace.idle_gaps(iv, host))
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)


def test_render_readers():
    ctx = _ctx("render")
    assert _read("device_busy_ms.render", ctx) == pytest.approx(25.0)
    ctx["trace"]["units"] = 5
    assert _read("device_busy_ms.render", ctx) == pytest.approx(10.0)
    ctx["trace"]["units"] = 2
    assert _read("launches_per_spp", ctx) == 2.0
    assert _read("shading_ms_per_spp", ctx) == pytest.approx(25.0)
    assert _read("device_busy_ms.grad", ctx) is None
    assert _read("launches_per_step", ctx) is None
    assert _read("scene_load_s", ctx) == 1.5
    assert _read("upload_s", ctx) == 2.5


def test_inverse_readers():
    ctx = _ctx("inverse")
    assert _read("device_busy_ms.grad", ctx) == pytest.approx(25.0)
    assert _read("launches_per_step", ctx) == 2.0
    assert _read("launches_per_spp", ctx) is None
    assert _read("k3_roofline", ctx) is None


def test_no_trace_no_reading():
    ctx = dict(kind="render", trace=dict(kernels=None, units=1, wall_s=1.0),
               k3=None, spans={})
    for name in ("device_busy_ms.render", "launches_per_spp",
                 "shading_ms_per_spp", "k3_roofline", "scene_load_s"):
        assert _read(name, ctx) is None


def test_k3_roofline():
    k3 = dict(seconds=0.1, calls=12, lanes=12 * 1000, node_visits=1e6,
              prim_tests=2e6, live_closest=5000)
    ops = peaks.OPS_PER_NODE * 1e6 + peaks.OPS_PER_PRIM * 2e6
    by_ops = ops / peaks.FP32_OPS_PER_S
    by_bytes = (peaks.RAY_BYTES * 12000 + peaks.RAY_LIVE_BYTES * 5000) \
        / peaks.HBM_BYTES_PER_S
    want = 100.0 * max(by_ops, by_bytes) / 0.1
    got = _read("k3_roofline", dict(kind="render", trace=None, k3=k3))
    assert got == pytest.approx(want)
    assert peaks.bound(1e6, 0)["bound_by"] == "bytes"
    assert peaks.bound(0, 1e6)["bound_by"] == "operations"
