"""Traffic of the kind `render`: a forward render of successive samples.

`Renderer._spp` (what `Renderer.render` calls a sample) renders samples 0,
1, ... into one film, the whole frame in one wavefront of `wavefront`
lanes (mix keys `xres`, `yres`, `wavefront`). End to end: the camera rays
of the samples completed in the window over the window. The check renders
the same samples of `check_pixels` film pixels drawn from the seed in the
reference. A traced run renders `trace_units` more samples under the
profiler, and one more with the per-ray counters on for `k3_roofline`.

A kind module gives the harness `run(cell, seed, seconds, traced,
device)` and `calibrate(cell, seed, device, samples)`."""

from __future__ import annotations

import time

import torch

from harness import compare, trace
from harness.program import (Program, describe, free, log, peak,
                             reference_scene, seed_of, sync, traced, window)


def reference_pixels(sc, tree, pix, n_samples: int, dtype=torch.float32):
    """Reference image at the film pixels `pix` over samples 0..n-1: every
    camera sample that lands in one of them (a sample can land in the pixel
    left of or above its own), box-filtered."""
    from reference import path as rp

    dev = pix.device
    w_, h_ = sc.xres, sc.yres
    x, y = pix % w_, pix // w_
    cand = torch.cat([pix, pix[x + 1 < w_] + 1, pix[y + 1 < h_] + w_,
                      pix[(x + 1 < w_) & (y + 1 < h_)] + w_ + 1]).unique()
    wanted = torch.zeros(w_ * h_, dtype=torch.bool, device=dev)
    wanted[pix] = True
    hal = rp.Halton(sc)
    lanes = cand.repeat(n_samples)
    s = torch.arange(n_samples, device=dev).repeat_interleave(len(cand))
    px, py = lanes % w_, lanes // w_
    pid, ok = rp.film_pixel(sc, hal, px, py, s)
    sel = ok & wanted[pid]
    px, py, s, pid = px[sel], py[sel], s[sel], pid[sel]
    L = rp.radiance(sc, dict(kd=sc.kd, ks=sc.ks, rough=sc.rough,
                             light_L=sc.light_L), hal, px, py, s,
                    rp.tree_query(tree), dtype)
    rgb = torch.zeros((w_ * h_, 3), device=dev).index_add_(0, pid, L)
    wsum = torch.zeros(w_ * h_, device=dev).index_add_(
        0, pid, torch.ones_like(pid, dtype=torch.float32))
    return (rgb / wsum.clamp_min(1e-10)[:, None])[pix]


def checked_pixels(cell, seed, n_px, dev):
    gen = torch.Generator().manual_seed(seed_of(seed))
    return torch.randperm(n_px, generator=gen)[
        :cell["mix"]["check_pixels"]].to(dev)


def k3_sample(r, s):
    """K3's device seconds and work counts over one more sample rendered
    with the per-ray counters on."""
    dev = r.device
    r.collect_stats = True
    try:
        with trace.profiler() as prof:
            f = r._spp(r.new_film(), s)
            sync(dev)
    finally:
        r.collect_stats = False
    secs, calls = trace.kernel_seconds(prof, "traverse_treelets")
    if not calls:
        return None
    aov = f.aov.double().sum(0)
    return dict(seconds=secs, calls=calls, lanes=calls * r.batch,
                node_visits=float(aov[0]), prim_tests=float(aov[2]),
                live_closest=float(aov[3]))


def run(cell, seed, seconds, traced_run, device):
    mix = cell["mix"]
    prog = Program(cell, seed, device)
    r, dev = prog.renderer, prog.device
    r._spp(r.new_film(), 0)              # every kernel and shape of a sample
    sync(dev)
    setup_end = time.time()
    log(f"set-up done: scene load {prog.scene_load_s:.2f} s, upload "
        f"{prog.upload_s:.2f} s")
    state = dict(film=r.new_film())

    def sample(s):
        state["film"] = r._spp(state["film"], s)

    win = window(sample, seconds, dev)
    n = win["units"]
    top = peak(dev)
    summary = k3 = None
    if traced_run:
        summary = traced(sample, n, mix["trace_units"], dev)
        n_all = n + mix["trace_units"]
        log(f"traced {mix['trace_units']} samples in "
            f"{summary['wall_s']:.2f} s")
        k3 = k3_sample(r, n_all)
    else:
        n_all = n
    film = state.pop("film")
    img = film.rgb / film.weight.clamp_min(1e-10)[:, None]
    n_px = r.n_pixels
    pix = checked_pixels(cell, seed, n_px, dev)
    prog_px = img[pix].clone()
    spans = prog.spans()
    del prog, r, film, img
    free(dev)
    log(describe(win, "samples"))
    sc, tree = reference_scene(cell, seed, dev)
    ref_px = reference_pixels(sc, tree, pix, n_all)
    log("reference pixels done")
    return dict(
        setup_end=setup_end, units=n, peak=top,
        numbers={"px_off_share": compare.pixel_off_share(prog_px, ref_px)},
        e2e={"camera_rays_per_s": n * n_px / win["elapsed"]},
        ctx=dict(kind="render", trace=summary, k3=k3, spans=spans))


def calibrate(cell, seed, dev, samples):
    """The control: the reference's pixels over `samples` samples with its
    shading chain in bfloat16, held against its float32 pixels."""
    sc, tree = reference_scene(cell, seed, dev)
    pix = checked_pixels(cell, seed, sc.xres * sc.yres, dev)
    ref = reference_pixels(sc, tree, pix, samples)
    ctl = reference_pixels(sc, tree, pix, samples, torch.bfloat16)
    return {"control": {"px_off_share": compare.pixel_off_share(ctl, ref)}}
