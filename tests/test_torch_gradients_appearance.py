"""Per-ray reverse-mode gradients of the PyTorch port against the JAX
package's `jax.grad` on test_torch_gradients' scene of every texture class
under an environment map (the appearance tables among them), and the tie
rule of |noise| at 0 that the port takes from JAX. Split from
test_torch_gradients.py, whose helpers and tolerances it shares, so that
the tier-1 run can spread the two files over its workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gradients import per_ray_gradients_match_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["appearance"])
def test_per_ray_gradients_match_jax(name, tmp_path, monkeypatch):
    """d/dtheta of sum(W * L) for a fixed random W, L the per-ray radiance
    of path_li over the renderer's camera rays of sample 0, with respect to
    all eight tables: the bench's four, the texture atlas and the
    environment map, whose gathers' cotangents add up per texel, and the
    camera matrices (whose gradient reaches the noise textures;
    test_noise_abs_takes_the_jax_tie_rule)."""
    per_ray_gradients_match_jax(name, tmp_path, monkeypatch)


def test_noise_abs_takes_the_jax_tie_rule():
    """Gradient noise is exactly 0 on the lattice lines of its cells, so a
    hit with two coordinates 0 (the appearance scene's centre pixel hits a
    marble statue at x = z = 0) takes |noise| at a tie in every octave
    whose scale keeps it there. jnp.abs's derivative at 0 is +1, torch.abs's
    0; the port's turbulence and windy take the JAX package's rule, and
    their gradients with respect to the point agree with jax.grad's there
    (with torch.abs the sixth octave's term was missing)."""
    from tpupt.textures import textures as jtex
    from tpupt_torch.textures import textures as ttex

    p = np.array([[0.0, 2.4529257, 0.0], [0.0, 1.25, 0.0],
                  [0.3, 0.7, 0.1]], np.float32)
    assert float(ttex.perlin(torch.tensor(p[:1] * 1.99 ** 5))) == 0.0
    for octaves in (1, 6):
        gj = np.asarray(jax.grad(lambda q: jtex.turbulence(
            q, 0.5, octaves).sum())(jnp.asarray(p)))
        pt = torch.from_numpy(p).requires_grad_()
        (gt,) = torch.autograd.grad(ttex.turbulence(pt, 0.5, octaves).sum(),
                                    pt)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5, atol=1e-6)
    x = torch.zeros(2, requires_grad=True)
    (g,) = torch.autograd.grad(ttex.abs_tie_up(x).sum(), x)
    assert g.tolist() == [1.0, 1.0] == [float(jax.grad(jnp.abs)(0.0))] * 2
