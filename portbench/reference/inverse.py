"""The reference's inverse-rendering step: the film of one sample of every
pixel, its L2 loss against a target image, the loss's gradients with
respect to the material and light tables, and a projected SGD update; and
the film of given samples, which makes a training cell's target image.

Pass 1 renders every lane without autograd and keeps its ray queries;
pass 2 renders blocks of lanes again with autograd on, over the kept
queries, and back-propagates each lane's share of the loss (the ray
queries are constants of differentiation, so the two passes trace the
same paths). Gradients are summed over the blocks in float64. The update
is SGD with a rate a leaf, projected onto the leaf's range."""

from __future__ import annotations

import torch

from reference import path as rp

LEAVES = ("kd", "ks", "rough", "light_L")


def image(sc, L, pid, ok):
    """(image (H*W,3), weight (H*W,)) of one radiance per lane, box filter."""
    n = sc.xres * sc.yres
    rgb = torch.zeros((n, 3), device=L.device).index_add_(
        0, pid, L * ok[:, None])
    w = torch.zeros(n, device=L.device).index_add_(0, pid, ok.float())
    return rgb / w.clamp_min(1e-10)[:, None], w


def pooled_l2(img, target, xres: int, yres: int, pool: int, has=None):
    """A training cell's loss: the mean over pool x pool blocks of the film
    of the squared gap between the block's mean colour and the target's.
    Averaging a block first keeps one sample's noise (whose variance falls
    with the albedo) from pulling the fit toward darker tables. Where `has`
    marks the pixels that got a sample, a block's mean is over those and
    the loss's over the blocks that hold one."""
    def blocks(x):
        return x.reshape(yres // pool, pool, xres // pool, pool, -1).sum(
            (1, 3))
    tgt = blocks(target) / (pool * pool)
    if has is None:
        return ((blocks(img) / (pool * pool) - tgt) ** 2).mean()
    cnt = blocks(has.to(img.dtype)[:, None])
    gap = (blocks(img * has[:, None]) / cnt.clamp_min(1.0) - tgt) ** 2
    return (gap * (cnt > 0)).sum() / ((cnt > 0).sum() * gap.shape[-1])


def step(sc, tree, params: dict, s: int, loss_fn, dtype=torch.float32,
         block: int = 1 << 18, keep=None):
    """(loss, grads, image) of sample s for the tables in `params`;
    `loss_fn(image, has)` is the loss of the film's image, `has` the pixels
    that got a sample where `keep` (a mask of lanes) leaves some out."""
    hal = rp.Halton(sc)
    dev = sc.p0.device
    py, px = torch.meshgrid(torch.arange(sc.yres, device=dev),
                            torch.arange(sc.xres, device=dev), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    rec = rp.Recorder(tree)
    with torch.no_grad():
        L = rp.radiance(sc, params, hal, px, py, s, rec.record, dtype)
        pid, ok = rp.film_pixel(sc, hal, px, py, s)
        if keep is not None:
            ok = ok & keep
        img, w = image(sc, L, pid, ok)
    with torch.enable_grad():
        im = img.detach().double().requires_grad_()
        loss = loss_fn(im, None if keep is None else w > 0)
        g_img, = torch.autograd.grad(loss, im)
    cot = (g_img.float() / w.clamp_min(1e-10)[:, None])[pid] * ok[:, None]
    del L
    leaves = {k: params[k].detach().clone().requires_grad_() for k in LEAVES}
    acc = {k: torch.zeros_like(v, dtype=torch.float64)
           for k, v in leaves.items()}
    for b0 in range(0, len(px), block):
        lanes = slice(b0, b0 + block)
        with torch.enable_grad():
            Lb = rp.radiance(sc, leaves, hal, px[lanes], py[lanes], s,
                             rec.replay(lanes), dtype)
            grads = torch.autograd.grad(Lb, list(leaves.values()),
                                        cot[lanes], allow_unused=True)
        for k, g in zip(leaves, grads):
            if g is not None:
                acc[k] += g.double()
        del Lb, grads
    return loss.item(), {k: v.float() for k, v in acc.items()}, img


def film_image(sc, tree, params: dict, samples, dtype=torch.float32):
    """Image (H*W,3) of the samples `samples` of every pixel with the
    tables in `params`, box-filtered, as a film accumulates them."""
    hal = rp.Halton(sc)
    dev = sc.p0.device
    py, px = torch.meshgrid(torch.arange(sc.yres, device=dev),
                            torch.arange(sc.xres, device=dev), indexing="ij")
    px, py = px.reshape(-1), py.reshape(-1)
    n = sc.xres * sc.yres
    rgb = torch.zeros((n, 3), device=dev)
    w = torch.zeros(n, device=dev)
    with torch.no_grad():
        for s in samples:
            L = rp.radiance(sc, params, hal, px, py, s, rp.tree_query(tree),
                            dtype)
            pid, ok = rp.film_pixel(sc, hal, px, py, s)
            rgb.index_add_(0, pid, L * ok[:, None])
            w.index_add_(0, pid, ok.float())
            del L
    return rgb / w.clamp_min(1e-10)[:, None]


def update(p, g, lr: float, lo: float, hi):
    """One step of SGD projected onto the leaf's range [lo, hi] (hi None:
    no upper end)."""
    return (p - lr * g).clamp(lo, hi)


def run(sc, tree, params: dict, steps, lr: dict, lo: dict, hi: dict,
        loss_fn, dtype=torch.float32, keep=None):
    """Follow the training steps `steps` (sample indices) from `params`,
    each leaf k updated by `update` with lr[k] and the range lo[k]..hi[k]:
    returns (losses, the first step's gradients as worked out from the
    tables after it, (p0 - p1) / lr, the tables' change over the steps,
    the first step's image, the first step's gradients as computed).
    `loss_fn` and `keep` are `step`'s."""
    cur = {k: params[k].detach().clone() for k in LEAVES}
    losses, first, first_img, raw = [], None, None, None
    for s in steps:
        loss, grads, img = step(sc, tree, cur, s, loss_fn, dtype, keep=keep)
        losses.append(loss)
        nxt = {k: update(cur[k], grads[k], lr[k], lo[k], hi[k])
               for k in LEAVES}
        if first is None:
            first_img, raw = img, grads
            first = {k: (cur[k].double() - nxt[k].double()) / lr[k]
                     for k in LEAVES}
        cur = nxt
    change = {k: cur[k].double() - params[k].double() for k in LEAVES}
    return losses, first, change, first_img, raw
