"""Traffic of the kind `inverse`: inverse rendering, a fit of the scene's
material and light tables to an image of the scene under other tables.

The target image is made in set-up by the reference (portbench/reference,
which reads nothing of the program): the scene rendered with its tables
(the program's names in `leaves`) each scaled entry by entry by a fixed set
of factors, evenly spaced over `target_factors` and permuted by the seed,
and kept in the leaf's range; `target_samples` gives the first sample
index and the count, far from the indices the steps take. A training step
is `Renderer.value_and_grad` of `pooled_l2` (the mean squared gap of
`pool` x `pool` block means) between the film of one sample and the
target, then SGD with a rate a leaf (`lr`) projected onto the leaf's range
(`lo`, `hi`: null for none); step k takes sample index k. Set-up drives the
first `setup_steps` steps through the window's own call, and the reference
follows them from its own tables and the same target. End to end: the
window's seconds over the steps completed in it. A traced run takes
`trace_units` more steps under the profiler.

A kind module gives the harness `run(cell, seed, seconds, traced,
device)` and `calibrate(cell, seed, device, samples)`."""

from __future__ import annotations

import time

import torch

from harness import compare
from harness.program import (Program, describe, free, log, peak,
                             reference_scene, seed_of, sync, traced, window)

REF_NAMES = {"mat_kd": "kd", "mat_ks": "ks", "mat_roughness": "rough",
             "light_L": "light_L"}


def _by_ref(mix, key):
    return {REF_NAMES[k]: v for k, v in mix[key].items()}


def target_tables(sc, mix, seed) -> dict:
    """The reference's tables scaled for the target: each leaf's entries
    times the same evenly spaced factors, in an order drawn from the
    seed, clamped to the leaf's range."""
    lo_f, hi_f = mix["target_factors"]
    lo, hi = _by_ref(mix, "lo"), _by_ref(mix, "hi")
    gen = torch.Generator().manual_seed(seed_of(seed))
    out = {}
    for name in (REF_NAMES[k] for k in mix["leaves"]):
        t = getattr(sc, name)
        f = torch.linspace(lo_f, hi_f, t.numel())[
            torch.randperm(t.numel(), generator=gen)]
        out[name] = (t * f.reshape(t.shape).to(t.device)).clamp(
            lo[name], hi[name])
    return out


def make_target(cell, seed, dev):
    """The target image (H*W,3), rendered by the reference."""
    from reference import inverse

    mix = cell["mix"]
    sc, tree = reference_scene(cell, seed, dev)
    first, count = mix["target_samples"]
    img = inverse.film_image(sc, tree, target_tables(sc, mix, seed),
                             range(first, first + count))
    del sc, tree
    return img


def loss_of(mix, target):
    """The loss of a film's image (and, for the reference, the pixels that
    got a sample) against the target."""
    from reference import inverse

    def loss(img, has=None):
        return inverse.pooled_l2(img, target.to(img.dtype), mix["xres"],
                                 mix["yres"], mix["pool"], has)
    return loss


def run(cell, seed, seconds, traced_run, device):
    from reference.inverse import update

    mix = cell["mix"]
    dev = torch.device(device)
    t0 = time.perf_counter()
    target = make_target(cell, seed, dev)
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"target image made by the reference in "
        f"{time.perf_counter() - t0:.2f} s")
    prog = Program(cell, seed, device)
    r = prog.renderer
    lr, lo, hi = mix["lr"], mix["lo"], mix["hi"]
    params = {k: getattr(r.ds, k).detach().clone() for k in mix["leaves"]}
    image_loss = loss_of(mix, target)

    def loss_fn(film):
        return image_loss(film.rgb / film.weight.clamp_min(1e-10)[:, None])

    losses = []

    def step(k):
        value, grads, film = r.value_and_grad(loss_fn, params, sample_idx=k)
        for n in params:
            params[n] = update(params[n], grads[n], lr[n], lo[n], hi[n])
        losses.append(float(value))
        return film

    p0 = {k: v.clone() for k, v in params.items()}
    for k in range(mix["setup_steps"]):
        film = step(k)
        if k == 0:
            img0 = film.rgb / film.weight.clamp_min(1e-10)[:, None]
            g0 = {n: (p0[n].double() - params[n].double()) / lr[n]
                  for n in params}
        del film
    p_end = {k: v.clone() for k, v in params.items()}
    sync(dev)
    setup_end = time.time()
    log(f"set-up done: scene load {prog.scene_load_s:.2f} s, upload "
        f"{prog.upload_s:.2f} s, losses {losses}")
    first = mix["setup_steps"]
    win = window(lambda i: step(first + i), seconds, dev)
    n = win["units"]
    top = peak(dev)
    log("window's losses " + " ".join(f"{x:.6g}" for x in losses[first:]))
    log("tables after the window: " + "; ".join(
        f"{k} {float(v.min()):.4g}..{float(v.max()):.4g}"
        for k, v in params.items()))
    summary = None
    if traced_run:
        summary = traced(lambda i: step(i), first + n, mix["trace_units"],
                         dev)
        log(f"traced {mix['trace_units']} steps in "
            f"{summary['wall_s']:.2f} s")
    spans = prog.spans()
    del prog, r, params
    free(dev)
    log(describe(win, "steps"))
    numbers = compare.inverse_numbers((
        losses[:first], {REF_NAMES[k]: v for k, v in g0.items()},
        {REF_NAMES[k]: p_end[k].double() - p0[k].double() for k in p0},
        img0), reference_steps(cell, seed, dev, target))
    log("reference steps done")
    return dict(
        setup_end=setup_end, units=n, peak=top, numbers=numbers,
        e2e={"step_ms": 1e3 * win["elapsed"] / n},
        ctx=dict(kind="inverse", trace=summary, k3=None, spans=spans))


def reference_steps(cell, seed, dev, target, dtype=torch.float32,
                    keep=None):
    """The reference's set-up steps from its own tables: `inverse.run`'s
    (losses, first gradients from the tables, change, first image, first
    gradients as computed)."""
    from reference import inverse

    mix = cell["mix"]
    sc, tree = reference_scene(cell, seed, dev)
    tables = dict(kd=sc.kd, ks=sc.ks, rough=sc.rough, light_L=sc.light_L)
    return inverse.run(sc, tree, tables, range(mix["setup_steps"]),
                       _by_ref(mix, "lr"), _by_ref(mix, "lo"),
                       _by_ref(mix, "hi"), loss_of(mix, target), dtype,
                       keep=keep)


def calibrate(cell, seed, dev, samples=0):
    """The control (the reference's steps in bfloat16) and the fault "half
    of the batch left out, the mean taken over the rest" (the reference's
    steps with the second half of the lanes dropped), each held against
    the reference's float32 steps. A step that returns its state unchanged
    reads 1 on `change_gap` by its definition and needs no run."""
    mix = cell["mix"]
    target = make_target(cell, seed, dev)
    ref = reference_steps(cell, seed, dev, target)
    n = mix["xres"] * mix["yres"]
    half = torch.arange(n, device=dev) < n // 2
    control = reference_steps(cell, seed, dev, target, torch.bfloat16)
    faulty = reference_steps(cell, seed, dev, target, keep=half)
    return {
        "control": compare.inverse_numbers(control[:4], ref),
        "half_batch": compare.inverse_numbers(faulty[:4], ref),
        "reference_grad_norms": {k: float(v.norm())
                                 for k, v in ref[4].items()},
    }
