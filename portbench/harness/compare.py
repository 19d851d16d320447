"""The numbers that decide `correct`, each held against the limit its mix
states. Every number is a gap between what the program's timed path
produced and what the plain reference (portbench/reference) works out
from the same inputs; PERF.md gives the readings each limit was set from."""

from __future__ import annotations

import math

import torch

PIXEL_TOL = 1e-3       # a pixel is off when a channel's gap passes this
PIXEL_FLOOR = 1e-2     # of the mean reference pixel, added to |ref|
LEAF_FLOOR = 1e-3      # leaves under this share of the median leaf's
#                        reference gradient move by round-off alone


def pixel_off_share(prog, ref) -> float:
    """Share of pixels (rows of (P,3) images) on which some channel's gap
    |prog - ref| / (|ref| + PIXEL_FLOOR * mean |ref|) passes PIXEL_TOL."""
    prog, ref = prog.double(), ref.double()
    scale = ref.abs() + PIXEL_FLOOR * ref.abs().mean()
    gap = ((prog - ref).abs() / scale.clamp_min(1e-30)).amax(-1)
    gap = torch.where(torch.isfinite(gap), gap, math.inf)
    return float((gap > PIXEL_TOL).double().mean())


def leaf_norm_gap(prog: dict, ref: dict, ref_grad: dict) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| / max(‖ref leaf‖, median ‖ref‖),
    over the leaves whose reference gradient is at least LEAF_FLOOR of the
    median leaf's."""
    gnorm = {k: float(v.double().norm()) for k, v in ref_grad.items()}
    gmed = sorted(gnorm.values())[len(gnorm) // 2]
    keep = [k for k in ref if gnorm[k] >= LEAF_FLOOR * gmed]
    pn = {k: float(prog[k].double().norm()) for k in keep}
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = sorted(rn.values())[len(rn) // 2]
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep]
    worst = max(gaps) if gaps else math.inf
    return worst if math.isfinite(worst) else math.inf


def judge(numbers: dict, limits: dict):
    """(correct, checks): each number that has a limit, beside it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def inverse_numbers(prog, ref) -> dict:
    """The training cell's numbers. `prog` is (losses of the steps
    followed, first gradients as worked out from the tables after the first
    step, the tables' change over the steps, the first step's image); `ref`
    is the same from the reference with its first gradients as computed
    last, which choose the leaves that count. Tables keyed alike."""
    losses, g0, change, img = prog
    r_losses, r_g0, r_change, r_img, r_raw = ref
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(losses, r_losses)),
        "grad_gap": leaf_norm_gap(g0, r_g0, r_raw),
        "change_gap": leaf_norm_gap(change, r_change, r_raw),
        "px_off_share": pixel_off_share(img, r_img),
    }
