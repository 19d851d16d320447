"""Film-level gradients of the PyTorch port against the JAX package's on
test_torch_gradients' textured, environment-lit scene (the texture atlas,
the environment map and the camera matrices among the tables). Split from
test_torch_train.py, whose helpers and tolerances it shares, so that the
tier-1 run can spread the files over its workers; the training step on
this scene is in test_torch_train_appearance_step.py."""

import pytest
import torch

from test_torch_train import film_gradients_match_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


@pytest.mark.parametrize("loss", ["appearance"])
def test_film_gradients_match_jax(loss, tmp_path, monkeypatch):
    """`Renderer.value_and_grad` at 1 spp against `jax.value_and_grad` of
    sum(film.rgb) on the textured, environment-lit scene with respect to
    the texture atlas, the environment map, light_L, roughness and the
    camera matrices (its Kd and Ks are all textures); the film is linear in
    light_L and env_map jointly."""
    film_gradients_match_jax(loss, tmp_path, monkeypatch)

