"""BDPT's gradients against `jax.vjp` of the JAX package's film step: the
cotangent on the film's rgb and on its t == 1 splats, as
test_torch_integrator_grads.py sets them out (its helpers, scene and
tolerances; this file holds the one case whose JAX side takes longest)."""

import torch

from test_torch_integrator_grads import integrator_gradients_match_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


def test_bdpt_gradients_match_jax(monkeypatch):
    integrator_gradients_match_jax("bdpt", monkeypatch)
