"""Film-level gradients of the PyTorch port against the JAX package's on
test_torch_gradients' small materials museum. Split from
test_torch_train.py, whose helpers and tolerances it shares, so that the
tier-1 run can spread the two files over its workers."""

import pytest
import torch

from test_torch_train import film_gradients_match_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


@pytest.mark.parametrize("loss", ["materials"])
def test_film_gradients_match_jax(loss, tmp_path, monkeypatch):
    """`Renderer.value_and_grad` at 1 spp against `jax.value_and_grad` of
    sum(film.rgb) on the small materials museum with respect to the bench's
    four tables (mat_kd on the rows where the JAX package's is not NaN,
    test_torch_gradients_materials.
    test_hair_lobes_of_other_lanes_make_the_jax_kd_gradient_nan)."""
    film_gradients_match_jax(loss, tmp_path, monkeypatch)
