"""Metropolis light transport of the PyTorch port against the JAX
package's, on the CPU and on the JAX package's tables: the mutation kernel,
the primary-sample columns BDPT asks for (the JAX package's request order,
and no aliasing: the port raises where the JAX package wraps a column with
`%`), the path kernel `eval_path` per lane on a shared sample matrix, the
bootstrap's normalisation b and a whole render's mean.

The JAX side runs `MLTRenderer`'s eval_path and step eagerly (their
unjitted functions, `__wrapped__`), with its walkers jitted once per scene.
Tolerances: `mutate` equal bit for bit on at least 99 % of the entries and
within 1e-6 on all (measured: 43 and 32 of 12,000 differ, by at most 85
ulp of a small coordinate): ATen's CPU `log` differs from XLA:CPU's in the
last bit on 18.6 % of float32 inputs (and `sqrt` on 1 %), and Winitzki's
erfinv cancels (sqrt(t^2 - ln(1 - x^2) / a) - t with t near 4.3), where
the two differ by up to 3.7e-5 absolute (held to 5e-5), times
sigma * sqrt(2);
eval_path's L and raster per lane within rtol 1e-4, atol 1e-5 on at least
99 % of the lanes (a last-bit difference of a walk can move a lane's path,
as in the films); b to rtol 1e-3 (float32 sums over lanes in another
order); the render's mean to 1 % (the chains take the same samples; a
last-bit difference can flip one acceptance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.integrators.mlt as jmlt
from tpupt_torch.integrators import mlt
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string

from test_torch_direct import pair, smoke_text

torch.set_num_threads(1)

RES, DEPTH, CHAINS = 8, 2, 256


def _eager(mr):
    mr._eval = mr._eval.__wrapped__
    mr._step = mr._step.__wrapped__
    return mr


def _pair():
    rj, rt = pair(smoke_text("mlt", res=RES, depth=DEPTH))
    mj = _eager(jmlt.MLTRenderer(rj, n_bootstrap=CHAINS * (DEPTH + 1),
                                 n_chains=CHAINS))
    mt = mlt.MLTRenderer(rt, n_bootstrap=CHAINS * (DEPTH + 1),
                         n_chains=CHAINS)
    return mj, mt


@pytest.mark.parametrize("key", [7, 0xFFFFFFFE])
def test_mutate_matches_jax(key):
    """Large and small steps and the wraparound, with the 32-bit key
    wrapping past 2^32 for the second and third streams."""
    u = np.random.default_rng(2).random((300, 40), np.float32)
    uj, lj = jmlt.mutate(jnp.asarray(u), jnp.uint32(key), 0.3, 0.01)
    ut, lt = mlt.mutate(torch.from_numpy(u), key, 0.3, 0.01)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert 0 < int(lt.sum()) < 300
    a, b = np.asarray(uj), ut.numpy()
    assert (a == b).mean() >= 0.99
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert ((ut >= 0) & (ut < 1)).all()
    x = np.random.default_rng(1).uniform(-1, 1, 10000).astype(np.float32)
    x[:3] = (-1.2, 0.0, 1.2)
    np.testing.assert_allclose(mlt._erfinv(torch.from_numpy(x)).numpy(),
                               np.asarray(jmlt._erfinv(jnp.asarray(x))),
                               rtol=0, atol=5e-5)


def _recording(monkeypatch, module, into):
    class Recording(module.PSSSampler):
        def __init__(self, u):
            super().__init__(u)
            into[u.shape[1]] = self.map

    monkeypatch.setattr(module, "PSSSampler", Recording)


def test_pss_columns_never_alias(monkeypatch):
    """BDPT asks for exactly n_pss_dims - 5 columns at every depth 1-5, so
    the JAX package's `%` never wraps there (the order of the requests is
    the JAX package's: test_eval_path_per_lane_matches_jax); a matrix one
    column short raises in the port."""
    cols = {}
    _recording(monkeypatch, mlt, cols)
    for md in range(1, 6):
        sc = flatten(parse_string(smoke_text("mlt", res=4, depth=md)))
        m = mlt.MLTRenderer(Renderer(sc, device="cpu"), n_chains=4)
        u = torch.rand((4, m.n_dims))
        m.eval_path(u, torch.full((4,), md, dtype=torch.int32))
        assert len(cols[m.n_dims]) == m.n_dims - mlt.PSSSampler.RESERVED
        with pytest.raises(AssertionError, match="PSS dimension"):
            m.eval_path(u[:, :-1], torch.full((4,), md, dtype=torch.int32))


def test_eval_path_per_lane_matches_jax(monkeypatch):
    """L(u | depth) and its raster per lane on one shared sample matrix,
    every depth and so every (s, t) strategy among the lanes; the
    dimension-to-column maps of both, request order included, equal."""
    maps_j, maps_t = {}, {}
    _recording(monkeypatch, jmlt, maps_j)
    _recording(monkeypatch, mlt, maps_t)
    mj, mt = _pair()
    rng = np.random.default_rng(8)
    u = rng.random((CHAINS, mt.n_dims), np.float32)
    depth = rng.integers(0, DEPTH + 1, CHAINS).astype(np.int32)
    Lj, prj = mj._eval(mj.r.ds, jnp.asarray(u), jnp.asarray(depth))
    Lt, prt = mt.eval_path(torch.from_numpy(u), torch.from_numpy(depth))
    assert list(maps_t[mt.n_dims].items()) == list(maps_j[mt.n_dims].items())
    ok = (np.isclose(Lt.numpy(), np.asarray(Lj), rtol=1e-4, atol=1e-5).all(-1)
          & np.isclose(prt.numpy(), np.asarray(prj), rtol=1e-4,
                       atol=1e-5).all(-1))
    assert ok.mean() >= 0.99, f"{(~ok).sum()} lanes differ"
    assert float(Lt.sum()) > 0 and (Lt > 0).any(-1).sum() > 10


def test_bootstrap_and_render_match_jax():
    """The bootstrap's b, and a render of two mutation passes: the image's
    mean and the film it leaves (its splats carry the estimate)."""
    mj, mt = _pair()
    img_j = mj.render(mutations_per_pixel=8, seed=3)
    img_t = mt.render(mutations_per_pixel=8, seed=3)
    np.testing.assert_allclose(mt.b, mj.b, rtol=1e-3)
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t.mean(), np.asarray(img_j).mean(),
                               rtol=1e-2)
    np.testing.assert_array_equal(
        mt.film.splat.numpy().reshape(RES, RES, 3), img_t)
