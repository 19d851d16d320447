"""The plain reference on tiny scenes: its tree walk against testing every
triangle, a lit floor against its closed form, and the sampler's range."""

import math

import _paths  # noqa: F401
import numpy as np
import pytest
import torch

from harness import manifest
from reference import inverse
from reference import bvh
from reference import path as rp
from reference import scene as rs


def _brute(p0, p1, p2, o, d, tmax):
    n = len(o)
    t = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int64)
    perm = bvh._permutation(d)
    for k in range(len(p0)):
        h, tt, _, _ = bvh._tri_test(o, *perm, p0[k].expand(n, 3),
                                    p1[k].expand(n, 3), p2[k].expand(n, 3), t)
        t = torch.where(h, tt, t)
        prim = torch.where(h, k, prim)
    return prim >= 0, t, prim


def test_tree_walk_equals_every_triangle():
    g = torch.Generator().manual_seed(3)
    c = torch.rand((300, 3), generator=g) * 10
    p0 = c + torch.rand((300, 3), generator=g) - 0.5
    p1 = c + torch.rand((300, 3), generator=g) - 0.5
    p2 = c + torch.rand((300, 3), generator=g) - 0.5
    # a floor wider than the rest, which the tree leaves out
    p0 = torch.cat([p0, torch.tensor([[-50.0, -50.0, -1.0]])])
    p1 = torch.cat([p1, torch.tensor([[50.0, -50.0, -1.0]])])
    p2 = torch.cat([p2, torch.tensor([[0.0, 50.0, -1.0]])])
    tree = bvh.build(p0, p1, p2)
    assert len(tree.big_ids) == 1
    o = torch.rand((2000, 3), generator=g) * 14 - 2
    d = rp.normalize(torch.randn((2000, 3), generator=g))
    tmax = torch.full((2000,), math.inf)
    tmax[:100] = 0.0
    valid, t, prim, _, _ = bvh.intersect(tree, o, d, tmax)
    bv, bt, bp = _brute(p0, p1, p2, o, d, tmax)
    assert valid.sum() > 500
    assert torch.equal(valid, bv)
    assert torch.equal(prim[valid], bp[bv])
    assert torch.equal(t[valid], bt[bv])
    occ = bvh.intersect(tree, o, d, tmax, any_hit=True)[0]
    assert torch.equal(occ, bv)


def _floor_scene(light_from, kd=0.5, res=(24, 16)):
    big = 100.0
    floor = np.array([[-big, -big, 0], [big, -big, 0], [big, big, 0],
                      [-big, big, 0]], np.float32)
    return dict(
        meshes=[dict(p=(floor[[0, 0]], floor[[1, 2]], floor[[2, 3]]),
                     n=None, mat="floor", area_light=False)],
        materials=dict(floor=dict(type="matte", kd=(kd, kd, kd))),
        distant_L=(1.0, 2.0, 3.0), distant_from=light_from,
        camera=dict(pos=(0.0, -1.0, 5.0), look=(0.0, 0.0, 0.0),
                    up=(0.0, 0.0, 1.0), fov=40.0),
        film=res, max_depth=5, rr_threshold=1.0)


@pytest.mark.parametrize("light_from", [(0.0, 0.0, 1.0), (1.0, 0.0, 1.0)])
def test_lit_floor_closed_form(light_from):
    """A matte floor under a distant light and nothing else: each pixel is
    kd / pi * L * cos(theta), the one path that reaches the light (the
    bounce leaves the scene)."""
    sc = rs.build(_floor_scene(light_from), 9, "cpu")
    tree = bvh.build(sc.p0, sc.p1, sc.p2)
    pix = torch.arange(sc.xres * sc.yres)
    img = manifest.kind("render", _paths.ROOT).reference_pixels(
        sc, tree, pix, 2)
    # pixels that some sample lands in (the port's Halton jitter is 0 at
    # sample 0, so that sample lands in the pixel up and to the left)
    hal = rp.Halton(sc)
    got = torch.zeros(len(pix), dtype=torch.bool)
    for s in range(2):
        pid, ok = rp.film_pixel(sc, hal, pix % sc.xres, pix // sc.xres, s)
        got[pid[ok]] = True
    assert got.float().mean() > 0.9
    cos = light_from[2] / math.hypot(*light_from)
    want = 0.5 / math.pi * torch.tensor([1.0, 2.0, 3.0]) * cos
    torch.testing.assert_close(img[got], want.expand_as(img[got]),
                               rtol=1e-5, atol=0.0)
    assert (img[~got] == 0).all()


def test_sampler_range():
    sc = rs.build(_floor_scene((0.0, 0.0, 1.0), res=(40, 30)), 2**40 + 3,
                  "cpu")
    hal = rp.Halton(sc)
    py, px = torch.meshgrid(torch.arange(30), torch.arange(40),
                            indexing="ij")
    idx = hal.index(px.reshape(-1), py.reshape(-1), 5)
    for d in (0, 1, 2, 7, 39):
        u = hal.dim(idx, d)
        assert (u >= 0).all() and (u < 1).all()
    pid, ok = rp.film_pixel(sc, hal, px.reshape(-1), py.reshape(-1), 5)
    assert ok.all()


def test_pooled_l2():
    """Block means against the target's; with `has`, a block's mean over
    the pixels that got a sample and the loss over the blocks that hold
    one."""
    img = torch.arange(4 * 6 * 3, dtype=torch.float64).reshape(24, 3)
    tgt = torch.zeros_like(img)
    blocks = img.reshape(2, 2, 3, 2, 3).mean((1, 3))
    assert float(inverse.pooled_l2(img, tgt, 6, 4, 2)) == pytest.approx(
        float((blocks ** 2).mean()))
    assert float(inverse.pooled_l2(img, img, 6, 4, 2)) == 0.0
    has = torch.zeros(24, dtype=torch.bool)
    has[0] = True                    # one pixel of the first block alone
    want = float((img[0] ** 2).mean())
    assert float(inverse.pooled_l2(img, tgt, 6, 4, 2, has)) == \
        pytest.approx(want)
