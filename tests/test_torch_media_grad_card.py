"""K6's backward on the card (`gpu` marker: skipped without a CUDA
device; a CUDA kernel has no CPU mode): `tr_grid_backward` against its
plain version `tr_grid_backward_plain` on the same CUDA tensors, and the
`TrGrid` Function's gradients through the kernel against those through the
plain pair. Per-lane outputs to the bit; the atlas gradient, summed by
atomics in no fixed order, within 1e-5 of its largest. This file imports
no JAX (the card's machine runs the port alone); `python3 chip_smoke.py`
makes the same comparison at full size."""

import numpy as np
import pytest
import torch

from tpupt_torch.core import rng
from tpupt_torch.media import media as mmod
from tpupt_torch.ops import media_tracking as mtk

ATLAS_REL = 1e-5


def _lanes(dev, n=4099, res=12):
    g = np.random.default_rng(5)
    dens = g.random((res, res, res)).astype(np.float32)
    dens[: res // 2] = 0.0   # empty texels: the tie of max(x, 0)
    w2m = np.eye(4, dtype=np.float32)
    w2m[:3, :3] *= 0.5
    w2m[:3, 3] = 0.5
    mt = mmod.MediaTable(
        sigma_a=torch.tensor([[0.5, 0.6, 0.7], [0.1, 0.1, 0.1]]),
        sigma_s=torch.tensor([[2.0, 1.5, 1.0], [0.2, 0.2, 0.2]]),
        g=torch.zeros(2), majorant=torch.tensor([1.0, 0.3]),
        is_grid=torch.tensor([True, False]),
        density=torch.from_numpy(dens.reshape(-1)),
        dens_off=torch.zeros(2, dtype=torch.int32),
        dens_dims=torch.tensor([[res] * 3, [1, 1, 1]], dtype=torch.int32),
        w2m=torch.from_numpy(np.stack([w2m, np.eye(4, dtype=np.float32)])))
    mt = mmod.MediaTable(*[x.to(dev) for x in mt])
    o = torch.from_numpy(g.uniform(-1.2, 1.2, (n, 3)).astype(np.float32))
    d = torch.from_numpy(g.normal(size=(n, 3)).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_c = torch.from_numpy(g.uniform(0.0, 3.0, n).astype(np.float32))
    med = torch.from_numpy(g.choice(np.array([-1, 0, 0, 0, 1], np.int32), n))
    keys = rng.uniform_u32(torch.arange(n), 13)
    gt = torch.from_numpy(g.uniform(-1, 1, n).astype(np.float32))
    o, d, t_c, med, keys, gt = (x.to(dev) for x in (o, d, t_c, med, keys, gt))
    mi = med.clamp_min(0).long()
    live = mt.is_grid[mi] & (med >= 0)
    return mt, mi, o, d, t_c, keys, live, gt


@pytest.mark.gpu
def test_tr_grid_backward_kernel_equals_its_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    mt, mi, o, d, t_c, keys, live, g = _lanes(torch.device("cuda"))
    before = mtk.launches["tr_grid_backward"]
    gl_k, ga_k = mtk.tr_grid_backward(mt, mi, o, d, t_c, keys, live, g)
    assert mtk.launches["tr_grid_backward"] == before + 1
    gl_p, ga_p = mmod.tr_grid_backward_plain(mt, mi, o, d, t_c, keys, g,
                                             live)
    torch.cuda.synchronize()
    assert torch.equal(gl_k.view(torch.int32), gl_p.view(torch.int32))
    assert float((ga_k - ga_p).abs().max()) <= ATLAS_REL * float(
        ga_p.abs().max())
    assert float(ga_p.abs().max()) > 0

    # the Function: kernel forward and backward against the plain pair
    grads = {}
    for name in ("kernel", "plain"):
        leaves = [x.clone().requires_grad_()
                  for x in (mt.density, mt.w2m, o, d)]
        mtl = mt._replace(density=leaves[0], w2m=leaves[1])
        if name == "plain":
            saved = mtk._tr_grid, mtk.tr_grid_backward
            mtk._tr_grid = lambda mt_, mi_, o_, d_, t_, k_, l_, lib=None: (
                mmod.tr_grid_plain(mt_, mi_, o_, d_, t_, k_))
            mtk.tr_grid_backward = (
                lambda mt_, mi_, o_, d_, t_, k_, l_, g_, lib=None:
                mmod.tr_grid_backward_plain(mt_, mi_, o_, d_, t_, k_, g_, l_))
        try:
            trg = mtk.tr_grid(mtl, mi, leaves[2], leaves[3], t_c, keys, live)
            grads[name] = torch.autograd.grad(
                torch.where(live, trg, 0.0), leaves, grad_outputs=g)
        finally:
            if name == "plain":
                mtk._tr_grid, mtk.tr_grid_backward = saved
    for a, b in zip(grads["kernel"], grads["plain"]):
        assert float((a - b).abs().max()) <= ATLAS_REL * float(
            b.abs().max())
