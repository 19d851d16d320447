"""The Sobol half of tpupt_torch's low-discrepancy module and the samplers
built on it against the JAX package's, bit for bit: the generator matrices
(regenerated on the host from the Joe-Kuo data, whose npz the port keeps a
byte-for-byte copy of), the byte tables that take the place of the
column-by-column XOR, the radical-inverse permutations, the hash-based Owen
scramble (u32 arithmetic in int64; products split so that none passes
2^63) and every sample value of the sobol, 02sequence, lowdiscrepancy,
maxmindist and stratified samplers on a grid of (pixel, sample, dimension).
Everything is integer arithmetic until the last conversion to float32, so
every value is compared by its bits."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core import lowdiscrepancy as jld
from tpupt.samplers.samplers import WavefrontSampler as JaxSampler
from tpupt_torch.core import lowdiscrepancy as ld
from tpupt_torch.samplers.samplers import WavefrontSampler

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

NEW_SAMPLERS = ["sobol", "02sequence", "lowdiscrepancy", "maxmindist",
                "stratified"]
N_DIMS = 64


def _bits(x):
    return np.ascontiguousarray(np.asarray(x)).view(np.int32)


def _u32(gen, n):
    """uint32 values as int64, the high bit set in half of them."""
    return gen.integers(0, 2**32, n, dtype=np.int64)


def test_joekuo_data_is_a_copy():
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "tpupt", "core", "sobol_joekuo.npz"),
              "rb") as a, open(os.path.join(
                  here, "..", "tpupt_torch", "core", "sobol_joekuo.npz"),
                  "rb") as b:
        assert a.read() == b.read()


def test_sobol_matrices_and_byte_tables():
    """The matrices equal the JAX package's for 64 dims (and for the
    self-generated fallback at 33 bits' worth of a width it takes); the
    byte tables give the bits of tpupt's 32-term XOR for indices over the
    whole uint32 range, in every dimension."""
    m = ld.sobol_matrices(N_DIMS)
    np.testing.assert_array_equal(m, jld.sobol_matrices(N_DIMS))
    np.testing.assert_array_equal(ld.sobol_matrices(8, 24),
                                  jld.sobol_matrices(8, 24))
    tables = torch.from_numpy(ld.sobol_byte_tables(m))
    assert tuple(tables.shape) == (N_DIMS, 4, 256)
    idx = _u32(np.random.default_rng(0), 4096)
    idx[:4] = [0, 1, 2**31, 2**32 - 1]
    mj = jnp.asarray(jld.sobol_matrices(N_DIMS))
    for d in range(N_DIMS):
        want = np.asarray(jld.sobol_sample_bits(
            jnp.asarray(idx.astype(np.uint32)), d, mj)).astype(np.int64)
        got = ld.sobol_sample_bits(torch.from_numpy(idx), d, tables).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"dim {d}")


def test_owen_scramble_and_radical_inverse_permutations():
    gen = np.random.default_rng(1)
    x, seed = _u32(gen, 8192), _u32(gen, 8192)
    want = np.asarray(jld.owen_scramble_u32(
        jnp.asarray(x.astype(np.uint32)), jnp.asarray(seed.astype(np.uint32))))
    got = ld.owen_scramble_u32(torch.from_numpy(x), torch.from_numpy(seed))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    want = np.asarray(jld.laine_karras_permutation(
        jnp.asarray(x.astype(np.uint32)), jnp.asarray(seed.astype(np.uint32))))
    got = ld.laine_karras_permutation(torch.from_numpy(x),
                                      torch.from_numpy(seed))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    flat, offs = ld.compute_radical_inverse_permutations(7)
    jflat, joffs = jld.compute_radical_inverse_permutations(7)
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(offs, joffs)
    idx = _u32(gen, 2048)
    for dim in (1, 2, 5, 30):
        p = ld.PRIMES[dim]
        perm = flat[offs[dim]: offs[dim] + p]
        want = jld.scrambled_radical_inverse(
            dim, jnp.asarray(idx.astype(np.uint32)), jnp.asarray(perm))
        got = ld.scrambled_radical_inverse(dim, torch.from_numpy(idx),
                                           torch.from_numpy(perm))
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"dim {dim}")


@pytest.mark.parametrize("spp", [16, 5])
@pytest.mark.parametrize("name", NEW_SAMPLERS)
def test_sampler_values_bit_equal(name, spp):
    """Every value on the grid: 64x64 pixels x 16 sample indices as one
    batch of lanes, each of the 64 dimensions and the camera jitter; spp 16
    and 5 (maxmindist picks its matrices by log2 spp, stratified its
    strata by spp)."""
    px, py, s = np.meshgrid(np.arange(64, dtype=np.int32),
                            np.arange(64, dtype=np.int32),
                            np.arange(16, dtype=np.int32), indexing="ij")
    px, py, s = px.ravel(), py.ravel(), s.ravel()
    j = JaxSampler(name, 64, 64, spp, seed=3)
    t = WavefrontSampler(name, 64, 64, spp, seed=3)
    pj, qj, sj = (jnp.asarray(a) for a in (px, py, s))
    pt, qt, st = (torch.from_numpy(a) for a in (px, py, s))
    for d in range(N_DIMS):
        np.testing.assert_array_equal(
            _bits(t.dim(pt, qt, st, d)), _bits(j.dim(pj, qj, sj, d)),
            err_msg=f"{name} dim {d}")
    for k, (a, b) in enumerate(zip(j.camera_jitter(pj, qj, sj),
                                   t.camera_jitter(pt, qt, st))):
        np.testing.assert_array_equal(
            _bits(b), _bits(np.broadcast_to(np.asarray(a), px.shape)),
            err_msg=f"{name} jitter {k}")
    # a scalar sample index, as the renderer passes it
    np.testing.assert_array_equal(
        _bits(t.dim(pt, qt, 7, 9)), _bits(j.dim(pj, qj, jnp.uint32(7), 9)))
    v = t.dim(pt, qt, st, 11)
    assert float(v.min()) >= 0.0 and float(v.max()) < 1.0
