"""tpupt_torch samplers against the JAX package: bit-equal.

The port emulates uint32 arithmetic in int64 with masks; any missed wrap
shows here as a differing bit pattern. Both sides are called op by op (no
jit), so neither fuses a multiply-add."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core import rng as jrng
from tpupt.samplers.samplers import WavefrontSampler as JaxSampler
from tpupt_torch.core import rng as trng
from tpupt_torch.samplers.samplers import WavefrontSampler as TorchSampler


def _bits(x):
    return np.ascontiguousarray(np.asarray(x), np.float32).view(np.uint32)


def _grid(res, n=400, seed=0):
    gen = np.random.default_rng(seed + res)
    px = gen.integers(0, res, n).astype(np.int32)
    py = gen.integers(0, res, n).astype(np.int32)
    s = gen.integers(0, 64, n).astype(np.int32)
    # corners and the largest sample index always present
    px[:4], py[:4], s[:4] = [0, res - 1, 0, res - 1], [0, 0, res - 1, res - 1], 63
    return px, py, s


@pytest.mark.parametrize("res", [8, 512, 704])
def test_halton_camera_jitter_and_dims_bit_equal(res):
    px, py, s = _grid(res)
    sj = JaxSampler("halton", res, res, 64, seed=3)
    st = TorchSampler("halton", res, res, 64, seed=3)
    jpx, jpy, js = jnp.asarray(px), jnp.asarray(py), jnp.asarray(s).astype(jnp.uint32)
    tpx, tpy, ts = torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s)
    for a, b in zip(sj.camera_jitter(jpx, jpy, js), st.camera_jitter(tpx, tpy, ts)):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    for d in range(40):
        a = sj.dim(jpx, jpy, js, d)
        b = st.dim(tpx, tpy, ts, d)
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()), err_msg=f"dim {d}")


def test_halton_scalar_sample_index_bit_equal():
    """The renderer passes the sample index as one Python int."""
    px, py, _ = _grid(512)
    sj = JaxSampler("halton", 512, 512, 8)
    st = TorchSampler("halton", 512, 512, 8)
    for s in (0, 7, 63):
        a = sj.dim(jnp.asarray(px), jnp.asarray(py), jnp.uint32(s), 11)
        b = st.dim(torch.from_numpy(px), torch.from_numpy(py), s, 11)
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_pcg_hash_and_uniform_float_bit_equal():
    gen = np.random.default_rng(5)
    x = gen.integers(0, 2**32, 2000, dtype=np.uint64)
    x[:3] = [0, 2**32 - 1, 2**31]
    xj = jnp.asarray(x.astype(np.uint32))
    xt = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(jrng.pcg_hash(xj)).astype(np.int64),
                                  trng.pcg_hash(xt).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.hash_combine(xj, jnp.uint32(0xDEADBEEF))).astype(np.int64),
        trng.hash_combine(xt, 0xDEADBEEF).numpy())
    a = jrng.uniform_float(xj, jnp.uint32(7), 3)
    b = trng.uniform_float(xt, 7, 3)
    np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))
    assert float(b.max()) < 1.0 and float(b.min()) >= 0.0


def test_random_sampler_bit_equal():
    px, py, s = _grid(64)
    sj = JaxSampler("random", 64, 64, 4, seed=9)
    st = TorchSampler("random", 64, 64, 4, seed=9)
    for d in (0, 1, 5, 39):
        a = sj.dim(jnp.asarray(px), jnp.asarray(py), jnp.asarray(s).astype(jnp.uint32), d)
        b = st.dim(torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s), d)
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


@pytest.mark.parametrize("name", ["sobol", "02sequence", "maxmindist", "stratified"])
def test_unported_samplers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchSampler(name, 8, 8, 4)
