#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA package `tpupt_torch`.

    python3 chip_smoke.py            # everything, needs one CUDA device
    python3 chip_smoke.py --quick    # build + kernel checks on the small scenes
    python3 chip_smoke.py --profile  # everything + a torch.profiler pass of 1 spp

It builds every CUDA kernel from the sources in this checkout (one nvcc per
source, all started together), holds each against its plain PyTorch version
on the card, and drives the main path through the user-facing entry points
(parse_file -> flatten -> Renderer -> render) on two generated museums at
1024x1024: the small one (63,558 triangles), whose tables are single-level and go
through kernel `traverse_wide`, and the 1,032,454-triangle one, whose tables
are two-level and go through kernel `traverse_treelets`. The launch counts
show that each render went through its kernel, and each render is compared
with one made by the kernel's plain version. There is no fallback: without a
CUDA device, without the `tpupt_torch` package beside it, with a kernel that
does not build, launch or agree, or with any failed check, it exits with a
code other than 0 and prints no result line.

Output: one JSON object per phase (`env`, `kernels`, `main_path`), then the
card's name and power limit, the `{"kernels": [...]}` line, and last
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpupt_torch.accel import traverse as trav
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.core.sampling import cosine_sample_hemisphere
from tpupt_torch.core.vecmath import offset_ray_origin
from tpupt_torch.integrators.path import Renderer, shading_point
from tpupt_torch.materials import bsdf as bx
from tpupt_torch.native import get_lib as get_native_lib
from tpupt_torch.ops import traverse_treelets as tt
from tpupt_torch.ops import traverse_wide as tw
from tpupt_torch.scene.device import build_scene_bvh, upload
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes
from tpupt_torch.utils.build import BUILD_DIR, NVCC_FLAGS

ULP_LIMIT = 4            # t / b1 / b2 of kernel vs plain version, in ulps
MAIN_RES = 1024
MUSEUM_1M = dict(grid=8, seg=128, rings=64)      # 1,032,454 triangles
MUSEUM_65K = dict(grid=4, seg=64, rings=32)      # 63,558 triangles
SPP_1M = 4
SPP_65K = 2
N_CHECK_RAYS = 262144
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, float32 outside tensor cores
L2_FLUSH_BYTES = 256 * 1024 * 1024   # five times the card's 50 MB L2
# bytes a kernel loads of a row it visits: 14 of a node row's 16 float4, 4 of
# a triangle row's 8, 7 of a quadric row's 8; one int2 per treelet entered
NODE_ROW_BYTES, TRI_ROW_BYTES, QUADRIC_ROW_BYTES, TREELET_REF_BYTES = 224, 64, 112, 8
# per ray: tmax always (4 B), origin and direction when it is live (24 B);
# t, b1, b2, gid, row id and three counters written (32 B)
RAY_LIVE_BYTES, RAY_BYTES = 24, 4 + 32
# float32 operations of one interior-node step (8 x [6 sub, 6 mul, 12 min/max,
# 1 mul, 4 compares, 1 max] + 19 compare-exchanges of 5 ops) and of one
# triangle test (9 sub, 6 shear mul-sub pairs, 3 edge functions of 3 ops,
# t_scaled 5, det 2, 3 z mul, 1 div, 3 mul, ~10 compares)
OPS_PER_NODE = 8 * 30 + 19 * 5
OPS_PER_PRIM = 65

# every kernel of the main path: wrapper module, wrapper, plain version, the
# tables it reads (in the order of the plain version's `touched` masks)
KERNELS = {
    "traverse_wide": dict(
        mod=tw, call=tw.intersect_wide_cuda, plain=trav.intersect_wide,
        tables=("wide_nodes", "prim_rows"),
        replaces="tpupt/ops/traverse_pallas.py:314"),
    "traverse_treelets": dict(
        mod=tt, call=tt.intersect_treelets_cuda, plain=trav.intersect_two_level,
        tables=("top_nodes", "tl_nodes", "tl_prims", "tl_offsets"),
        replaces="tpupt/ops/traverse_stream.py:51"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance of two float32 tensors in units in the last place."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """As time_ms, but each call finds the L2 cache holding `flush` (a buffer
    larger than the cache, rewritten before every call) instead of the
    tables the call before it read."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def compare_hits(tag, kernel_out, plain_out, with_stats=True):
    """Mismatch counts and worst ulp distance of a kernel result against the
    plain version's; fails the run on any miss."""
    (hk, sk), (hp, sp) = kernel_out, plain_out
    valid = hp.valid
    res = dict(
        valid_mismatch=int((hk.valid != hp.valid).sum()),
        prim_mismatch=int((hk.prim != hp.prim).sum()),
        hits=int(valid.sum()),
    )
    if with_stats:
        res["counter_mismatch"] = int(
            (sk.node_visits != sp.node_visits).sum()
            + (sk.leaf_visits != sp.leaf_visits).sum()
            + (sk.prim_tests != sp.prim_tests).sum())
    both = valid & hk.valid
    worst = 0
    max_abs = 0.0
    if bool(both.any()):
        for name in ("t", "b1", "b2"):
            a, b = getattr(hk, name)[both], getattr(hp, name)[both]
            worst = max(worst, int(ulp_diff(a, b).max()))
            max_abs = max(max_abs, float((a - b).abs().max()))
        max_abs = max(max_abs, float(
            (hk.p_obj[both] - hp.p_obj[both]).abs().max()))
    res["max_ulp"] = worst
    res["max_abs_err"] = max_abs
    bad = (res["valid_mismatch"] or res["prim_mismatch"]
           or res.get("counter_mismatch", 0) or worst > ULP_LIMIT)
    if bad:
        fail(f"kernel disagrees with its plain version on {tag}: {res}")
    return res


def build_kernels():
    """Every kernel twice (as shipped, and with contraction of a*b+c allowed
    to record what the bit-exact build gives up; the latter is used for
    timing only), all four nvcc runs started together."""
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=4) as pool:
        shipped = {k: pool.submit(v["mod"].build, ["-Xptxas", "-v"])
                   for k, v in KERNELS.items()}
        fmad = {k: pool.submit(
            v["mod"].build, ["-fmad=true"],
            os.path.join(BUILD_DIR, f"libtpupt_{k}_fmad.so"))
            for k, v in KERNELS.items()}
        logs = {k: f.result()[1] for k, f in shipped.items()}
        fmad_libs = {k: KERNELS[k]["mod"].load(f.result()[0])
                     for k, f in fmad.items()}
    for v in KERNELS.values():
        v["mod"].get_lib()
    ptxas = {}
    for k, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        ptxas[k] = lines[-2:]   # the <any_hit, has_spheres, with_stats> = all-true variant
    return time.time() - t0, ptxas, fmad_libs


def check_cases(kind, cases, checks):
    """Kernel `kind` against its plain version on each case, closest and any
    hit, with and without counters; fails the run on any miss."""
    call, plain_fn = KERNELS[kind]["call"], KERNELS[kind]["plain"]
    for name, ds, st, o, d, tmax in cases:
        for any_hit in (False, True):
            mode = "any" if any_hit else "closest"
            t0 = time.time()
            plain = plain_fn(ds, st, o, d, tmax, any_hit=any_hit)
            torch.cuda.synchronize()
            checks[f"{kind}/{name}/{mode}/plain_ms"] = (time.time() - t0) * 1e3
            for with_stats in (True, False):
                tag = f"{kind}/{name}/{mode}/{'stats' if with_stats else 'nostats'}"
                out = call(ds, st, o, d, tmax, any_hit=any_hit,
                           with_stats=with_stats)
                torch.cuda.synchronize()
                res = compare_hits(tag, out, plain, with_stats)
                res["kernel_ms"] = time_ms(
                    lambda: call(ds, st, o, d, tmax, any_hit=any_hit,
                                 with_stats=with_stats), 5)
                checks[tag] = res


def drive(renderer, kind, spp):
    """Render `spp` samples through the entry point with the launch counts
    set to 0 just before and read just after. Returns (film, ms per spp,
    launches of every kernel)."""
    depth = renderer.scene.integrator.max_depth
    expect = 2 * (depth + 1) * renderer.n_batches * spp
    renderer.render(spp=1)   # warm-up outside the counted run
    torch.cuda.synchronize()
    for v in KERNELS.values():
        v["mod"].launches = 0
    t0 = time.time()
    film = renderer.render(spp=spp)
    torch.cuda.synchronize()
    ms_per_spp = (time.time() - t0) * 1e3 / spp
    counts = {k: v["mod"].launches for k, v in KERNELS.items()}
    tw.check_stack_depth()
    for k, c in counts.items():
        want = expect if k == kind else 0
        if c != want:
            fail(f"{kind} render launched {k} {c} times, expected {want}")
    return film, ms_per_spp, counts


def check_image(renderer, film, tag):
    img = renderer.image(film)
    if img.shape != (MAIN_RES, MAIN_RES, 3):
        fail(f"{tag}: image shape {img.shape}")
    finite_share = float(np.isfinite(img).all(-1).mean())
    mean_lum = float((img @ np.array([0.212671, 0.715160, 0.072169])).mean())
    if finite_share != 1.0 or not mean_lum > 0.0:
        fail(f"{tag}: finite share {finite_share}, mean luminance {mean_lum}")
    return finite_share, mean_lum


def against_plain_render(renderer, scene, tables, kind, dev):
    """1 spp through the kernel against 1 spp through its plain version."""
    plain_fn = KERNELS[kind]["plain"]

    def plain_isect(ds_, st_, o_, d_, tmax_, any_hit=False):
        return plain_fn(ds_, st_, o_, d_, tmax_, any_hit=any_hit)

    img_k = renderer.image(renderer.render(spp=1))
    t0 = time.time()
    plain_renderer = Renderer(scene, device=dev, tables=tables, isect=plain_isect)
    img_p = plain_renderer.image(plain_renderer.render(spp=1))
    torch.cuda.synchronize()
    seconds = time.time() - t0
    rel = float(np.abs(img_k.mean((0, 1)) - img_p.mean((0, 1))).max()
                / max(float(img_p.mean()), 1e-12))
    if not rel <= 1e-4:
        fail(f"{kind} render differs from its plain-version render: rel {rel}")
    return {"plain_render_s": round(seconds, 1), "plain_vs_kernel_mean_rel": rel,
            "plain_vs_kernel_max_pixel_abs": float(np.abs(img_k - img_p).max())}


def main(argv) -> int:
    quick = "--quick" in argv
    with_profile = "--profile" in argv
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA device")
    dev = torch.device("cuda:0")

    # ------------------------------ env ---------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    kernel_build_s, ptxas, fmad_libs = build_kernels()
    t0 = time.time()
    get_native_lib()
    native_build_s = time.time() - t0
    emit({"phase": "env", "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernel_build_s": round(kernel_build_s, 2),
          "native_build_s": round(native_build_s, 2),
          "nvcc_flags": NVCC_FLAGS, "ptxas_all_true_variant": ptxas})

    # ----------------------------- kernels ------------------------------
    def upload_text(txt, **kw):
        sc = flatten(parse_string(txt))
        return upload(sc, light_strategy="spatial", device=dev, **kw)

    def rays_to(o, d):
        return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))

    def museum_scene(tmp, **size):
        path = genscene.museum(tmp, **size)
        return flatten(parse_file(path), os.path.dirname(path))

    inf_rays = torch.full((N_CHECK_RAYS,), float("inf"), device=dev)
    checks = {}
    with tempfile.TemporaryDirectory() as tmp:
        o, d = rays_to(*testscenes.aimed_rays(
            N_CHECK_RAYS, 19, [-3, -3, -3], [3, 3, 3], 7.0))
        wide_cases, treelet_cases = [], []
        ds, st = upload_text(testscenes.random_triangles_pbrt(60, 0))
        wide_cases.append(("random_triangles", ds, st, o, d, inf_rays))
        ds, st = upload_text(testscenes.quadric_kinds_pbrt())
        if st.n_spheres != 7:
            fail("quadric scene lost its quadrics")
        wide_cases.append(("quadric_kinds", ds, st, o, d, inf_rays))
        # every quadric kind among 300 triangles, cut into small treelets
        ds, st = upload_text(testscenes.quadric_kinds_pbrt(n_tris=300),
                             two_level=True, treelet_budget=(4, 128))
        if st.n_spheres != 7 or st.n_treelets < 8:
            fail(f"two-level quadric scene: {st.n_spheres} quadrics, "
                 f"{st.n_treelets} treelets")
        treelet_cases.append(("quadric_kinds_300", ds, st, o, d, inf_rays))

        # museum, 63,558 triangles (native sweep-SAH build): camera rays plus
        # cosine-scattered secondary rays from their hits; its own
        # single-level tables, and two-level tables at the default capacities
        sc65 = museum_scene(tmp, **MUSEUM_65K)
        sc65_small = with_resolution(sc65, 512, 256)
        t0 = time.time()
        bvh65 = build_scene_bvh(sc65)
        tables65 = upload(sc65, bvh=bvh65, light_strategy="spatial", device=dev)
        sah_65k_s = time.time() - t0
        if tables65[1].two_level:
            fail("the small museum should take single-level tables")
        o2, d2, tm2 = mixed_rays(sc65_small, *tables65, dev)
        wide_cases.append(("museum_65k", *tables65, o2, d2, tm2))
        ds, st = upload(sc65, bvh=bvh65, light_strategy="spatial", device=dev,
                        two_level=True)
        treelet_cases.append(("museum_65k", ds, st, o2, d2, tm2))

        check_cases("traverse_wide", wide_cases, checks)
        check_cases("traverse_treelets", treelet_cases, checks)
        tw.check_stack_depth()
        for tag in ("traverse_wide/quadric_kinds/closest/stats",
                    "traverse_treelets/quadric_kinds_300/closest/stats"):
            if checks[tag]["hits"] < 1000:
                fail(f"{tag}: hardly hit, the check is vacuous")
        emit({"phase": "kernels", "rays": N_CHECK_RAYS, "ulp_limit": ULP_LIMIT,
              "sah_build_upload_65k_s": round(sah_65k_s, 2),
              "launches_during_checks": {k: v["mod"].launches
                                         for k, v in KERNELS.items()},
              "checks": checks})
        if quick:
            emit({"quick": True, "seconds": round(time.time() - t_start, 1)})
            return 0

        # ---------------------------- main path -------------------------
        t0 = time.time()
        scene_path = genscene.museum(tmp, **MUSEUM_1M)
        t_gen = time.time() - t0
        t0 = time.time()
        desc = parse_file(scene_path)
        t_parse = time.time() - t0
        t0 = time.time()
        scene = flatten(desc, os.path.dirname(scene_path))
        t_flatten = time.time() - t0
    for sc in (scene, sc65):
        if (sc.film.xres, sc.film.yres) != (MAIN_RES, MAIN_RES):
            fail(f"museum film is {sc.film.xres}x{sc.film.yres}")

    # single-level tables -> traverse_wide
    r65 = Renderer(sc65, device=dev, tables=tables65)
    film65, ms65, counts65 = drive(r65, "traverse_wide", SPP_65K)
    fin65, lum65 = check_image(r65, film65, "museum_65k")
    plain65 = against_plain_render(r65, sc65, tables65, "traverse_wide", dev)

    # two-level tables -> traverse_treelets
    t0 = time.time()
    bvh = build_scene_bvh(scene)
    t_bvh = time.time() - t0
    t0 = time.time()
    tables = upload(scene, bvh=bvh,
                    light_strategy=scene.integrator.light_strategy, device=dev)
    torch.cuda.synchronize()
    t_upload = time.time() - t0
    ds, st = tables
    if not st.two_level:
        fail("the 1,032,454-triangle museum should take two-level tables")
    table_bytes = sum(t.numel() * t.element_size() for t in ds)
    renderer = Renderer(scene, device=dev, tables=tables)
    film, ms_per_spp, counts = drive(renderer, "traverse_treelets", SPP_1M)
    finite_share, mean_lum = check_image(renderer, film, "museum_1m")
    aov = renderer.aovs(film)
    plain1m = against_plain_render(renderer, scene, tables,
                                   "traverse_treelets", dev)
    main_launches = {"traverse_wide": counts65["traverse_wide"],
                     "traverse_treelets": counts["traverse_treelets"]}

    # ---- each kernel at the main path's shape: one 131,072-ray batch of the
    # 1M museum, the same rays for both (single-level tables built for it)
    t0 = time.time()
    tables_1l = upload(scene, bvh=bvh,
                       light_strategy=scene.integrator.light_strategy,
                       device=dev, two_level=False)
    t_upload_1l = time.time() - t0
    rays = main_shape_rays(renderer, scene, tables_1l, dev)
    shape = {"rays": renderer.batch, "live_rays": int((rays[2] > 0).sum()),
             "traverse_wide": main_shape_timing(
                 "traverse_wide", tables_1l, rays, fmad_libs),
             "traverse_treelets": main_shape_timing(
                 "traverse_treelets", tables, rays, fmad_libs)}
    same = (shape["traverse_wide"].pop("prims"), shape["traverse_treelets"].pop("prims"))
    shape["closest_prim_differs_between_levels"] = int((same[0] != same[1]).sum())
    # the single-level kernel on the very tree the treelets were cut from
    # (the two-level upload keeps it): what the second level itself costs
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    cut = torch.where(rays[2] > 0, half, 0.0).contiguous()
    shape["traverse_wide_on_the_treelets_tree_ms"] = {
        "closest": time_ms(lambda: tw.intersect_wide_cuda(
            ds, st, rays[0], rays[1], rays[2]), 10),
        "any": time_ms(lambda: tw.intersect_wide_cuda(
            ds, st, rays[0], rays[1], cut, any_hit=True), 10)}
    if with_profile:
        emit({"phase": "profile", **profile_one_spp(renderer)})
    emit({"phase": "main_path",
          "museum_65k": {
              "triangles": tables65[1].n_tris, "two_level": False,
              "wide_nodes": tables65[1].n_wide_nodes, "spp": SPP_65K,
              "ms_per_spp": ms65,
              "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms65 * 1e-3),
              "launches": counts65, "finite_pixel_share": fin65,
              "mean_luminance": lum65, **plain65},
          "museum_1m": {
              **MUSEUM_1M, "triangles": st.n_tris, "two_level": True,
              "wide_nodes": st.n_wide_nodes, "top_nodes": int(ds.top_nodes.shape[0]),
              "treelets": st.n_treelets, "treelet_capacity": [st.tl_tn, st.tl_tp],
              "bvh_nodes": st.n_nodes, "max_leaf": st.max_leaf,
              "table_bytes_on_device": table_bytes,
              "host_s": {"generate": round(t_gen, 2), "parse": round(t_parse, 2),
                         "flatten": round(t_flatten, 2), "bvh_lbvh": round(t_bvh, 2),
                         "collapse_treelets_pack_upload": round(t_upload, 2),
                         "single_level_tables_for_comparison": round(t_upload_1l, 2)},
              "resolution": [MAIN_RES, MAIN_RES],
              "max_depth": scene.integrator.max_depth,
              "spp": SPP_1M, "batches": renderer.n_batches,
              "batch_rays": renderer.batch, "ms_per_spp": ms_per_spp,
              "camera_rays_per_s": MAIN_RES * MAIN_RES / (ms_per_spp * 1e-3),
              "launches": counts, "finite_pixel_share": finite_share,
              "mean_luminance": mean_lum,
              "mean_node_visits": float(aov["node_visits"].mean()),
              "mean_prim_tests": float(aov["prim_tests"].mean()),
              "mean_path_length": float(aov["path_length"].mean()), **plain1m},
          "kernels_at_main_shape": shape})

    kernels = []
    for kind, spec in KERNELS.items():
        sh = shape[kind]
        kernels.append({
            "name": kind, "route": "cuda",
            "source": f"tpupt_torch/csrc/{kind}.cu",
            "replaces": spec["replaces"],
            "launches": main_launches[kind],
            "max_abs_err": max(
                [c["max_abs_err"] for tag, c in checks.items()
                 if tag.startswith(kind + "/") and isinstance(c, dict)]
                + [sh["closest"]["max_abs_err"], sh["any"]["max_abs_err"]]),
            "ms": sh["closest"]["kernel_ms"],
            "plain_ms": sh["closest"]["plain_ms"],
            "bound_ms": sh["closest"]["bound_ms"],
            "bound_by": sh["closest"]["bound_by"],
            "library_ms": None,
            "any_hit_ms": sh["any"]["kernel_ms"],
            "any_hit_bound_ms": sh["any"]["bound_ms"],
            "rays_per_launch": shape["rays"],
            "tolerance": f"valid/prim/counters exact, t/b1/b2 <= {ULP_LIMIT} ulp",
        })
    emit({"phase": "done", "seconds": round(time.time() - t_start, 1)})
    print(card_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True,
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


def profile_one_spp(renderer):
    """Device time by kernel name over one sample of the 1M museum, from
    torch.profiler: what share the traversal kernel has, and how much of the
    wall time the device is busy at all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.render(spp=1)
        torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    # kernel rows only: the profiler also credits each kernel's time to the
    # operator that launched it, and summing both would count it twice
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        on_device = str(getattr(e, "device_type", "")).upper().endswith("CUDA")
        if dev_us > 0 and on_device:
            rows.append((e.key, dev_us / 1e3, e.count))
    if not rows:
        fail("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)
    walk = [r for r in rows if "traverse_" in r[0] and "_kernel" in r[0]]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": dev_ms,
            "device_busy_share": dev_ms / wall_ms if wall_ms else None,
            "device_kernel_launches": sum(r[2] for r in rows),
            "traversal_kernel_ms": sum(r[1] for r in walk),
            "traversal_kernel_launches": sum(r[2] for r in walk),
            "top_kernels": [{"name": r[0][:80], "ms": round(r[1], 3),
                             "launches": r[2]} for r in rows[:10]]}


def secondary_rays(ds, st, hit, o, d, seed):
    """Cosine-scattered rays from the hits of (o, d): what a diffuse bounce
    hands the next traversal. Lanes that missed come back dead (tmax 0)."""
    n = o.shape[0]
    gen = np.random.default_rng(seed)
    u = torch.from_numpy(gen.random((2, n), dtype=np.float32)).to(o.device)
    sp = shading_point(ds, st, hit, o, d)
    t_f, b_f, n_f = bx.make_frame(sp.ns)
    wi = bx.to_world(t_f, b_f, n_f, cosine_sample_hemisphere(u[0], u[1]))
    o2 = offset_ray_origin(sp.p, sp.ng, wi)
    tmax = torch.where(hit.valid, float("inf"), 0.0).to(torch.float32)
    return o2.contiguous(), wi.contiguous(), tmax


def camera_rays(scene, ds, dev, xres, yres, seed):
    gen = np.random.default_rng(seed)
    py, px = np.meshgrid(np.arange(yres), np.arange(xres), indexing="ij")
    jit = gen.random((2, xres * yres), dtype=np.float32)
    p_raster = np.stack([px.ravel() + jit[0], py.ravel() + jit[1]], -1)
    p_raster = torch.from_numpy(p_raster.astype(np.float32)).to(dev)
    cam = scene.camera
    o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                         p_raster, torch.zeros_like(p_raster),
                         cam.lens_radius, cam.focal_distance)
    return o.contiguous(), d.contiguous()


def mixed_rays(scene, ds, st, dev):
    """131,072 camera rays of the scene's camera (at the scene's resolution)
    plus the 131,072 secondary rays scattered from their hits."""
    o, d = camera_rays(scene, ds, dev, scene.film.xres, scene.film.yres, 23)
    tmax = torch.full((o.shape[0],), float("inf"), device=dev)
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, tmax)
    o2, d2, tmax2 = secondary_rays(ds, st, hit, o, d, 29)
    return (torch.cat([o, o2]).contiguous(), torch.cat([d, d2]).contiguous(),
            torch.cat([tmax, tmax2]).contiguous())


def main_shape_rays(renderer, scene, tables_1l, dev):
    """One batch of the main path's size on the main path's scene: the
    secondary rays of the camera batch in the middle of the image, where the
    statues stand. Returns (o, d, tmax) with dead lanes at tmax 0."""
    ds, st = tables_1l
    # a batch's pixels are 32x32 tiles; take its raster positions
    mid = renderer.n_batches // 2
    px = renderer._px_b[mid].to(torch.float32) + 0.5
    py = renderer._py_b[mid].to(torch.float32) + 0.5
    p_raster = torch.stack([px, py], -1)
    cam = scene.camera
    o, d = generate_rays(cam.type, ds.raster_to_camera, ds.cam_to_world,
                         p_raster, torch.zeros_like(p_raster),
                         cam.lens_radius, cam.focal_distance)
    o, d = o.contiguous(), d.contiguous()
    inf = torch.full((renderer.batch,), float("inf"), device=dev)
    hit, _ = tw.intersect_wide_cuda(ds, st, o, d, inf)
    return secondary_rays(ds, st, hit, o, d, 31)


def main_shape_timing(kind, tables, rays, fmad_libs):
    """Kernel `kind`, its plain version and its bound on `rays` (closest
    hit) and on the same rays cut to half the scene's diagonal (any hit).

    bound_ms is the larger of (a) the bytes the call must move at least once
    over the card's memory rate: every table row that some ray of this batch
    reads, counted once however many rays read it (the plain version marks
    them) and at the bytes the kernel loads of it, plus the rays read and the
    records written; and (b) the float32 operations of this batch's node
    steps and prim tests over the card's float32 rate."""
    ds, st = tables
    spec = KERNELS[kind]
    call, plain_fn = spec["call"], spec["plain"]
    o2, d2, tmax2 = rays
    n = o2.shape[0]
    prim_table = getattr(ds, spec["tables"][-2] if kind == "traverse_treelets"
                         else spec["tables"][1])
    is_tri = prim_table.view(torch.int32)[:, 17] == 1
    half = float(torch.linalg.norm(ds.world_hi - ds.world_lo)) * 0.5
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=o2.device)
    out = {}
    for mode, any_hit, tmax in (
            ("closest", False, tmax2),
            ("any", True, torch.where(tmax2 > 0, half, 0.0).contiguous())):
        kernel = call(ds, st, o2, d2, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        masks = [torch.zeros(getattr(ds, t).shape[0], dtype=torch.bool,
                             device=o2.device) for t in spec["tables"]]
        t0 = time.time()
        plain = plain_fn(ds, st, o2, d2, tmax, any_hit=any_hit, touched=masks)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        res = compare_hits(f"{kind}/museum_1m/{mode}", kernel, plain)
        stats = kernel[1]
        nodes = int(stats.node_visits.sum())
        tests = int(stats.prim_tests.sum())
        if kind == "traverse_treelets":
            rows = {"nodes": int(masks[0].sum()) + int(masks[1].sum()),
                    "treelets": int(masks[3].sum())}
            prim_mask = masks[2]
        else:
            rows = {"nodes": int(masks[0].sum()), "treelets": 0}
            prim_mask = masks[1]
        rows["triangles"] = int((prim_mask & is_tri).sum())
        rows["quadrics"] = int((prim_mask & ~is_tri).sum())
        live = int((tmax > 0).sum())
        bytes_moved = (NODE_ROW_BYTES * rows["nodes"]
                       + TRI_ROW_BYTES * rows["triangles"]
                       + QUADRIC_ROW_BYTES * rows["quadrics"]
                       + TREELET_REF_BYTES * rows["treelets"]
                       + RAY_LIVE_BYTES * live + RAY_BYTES * n)
        ops = OPS_PER_NODE * nodes + OPS_PER_PRIM * tests
        by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        by_ops = ops / FP32_OPS_PER_S * 1e3
        lib_fmad = fmad_libs[kind]
        res.update(
            kernel_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit), 10),
            kernel_cold_l2_ms=time_cold_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit), 10, flush),
            kernel_nostats_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit, with_stats=False), 10),
            kernel_fmad_true_ms=time_ms(lambda: call(
                ds, st, o2, d2, tmax, any_hit=any_hit, lib=lib_fmad), 10),
            plain_ms=plain_ms, node_visits=nodes, prim_tests=tests,
            distinct_rows_read=rows, bytes_moved_at_least=bytes_moved,
            bytes_if_every_visit_missed_cache=(
                NODE_ROW_BYTES * nodes + TRI_ROW_BYTES * tests),
            float_ops=ops, bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
        fm = call(ds, st, o2, d2, tmax, any_hit=any_hit, lib=lib_fmad)
        res["fmad_true_prim_mismatch"] = int((fm[0].prim != plain[0].prim).sum())
        res["fmad_true_counter_mismatch"] = int(
            (fm[1].node_visits != plain[1].node_visits).sum())
        out[mode] = res
        if mode == "closest":
            out["prims"] = kernel[0].prim
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
