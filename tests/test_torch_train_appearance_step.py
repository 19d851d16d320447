"""The training step of the PyTorch port against the JAX package's on
test_torch_gradients' textured, environment-lit scene. Split from
test_torch_train_appearance.py (the film-level gradients of the same
scene), whose helpers in test_torch_train.py it shares, so that the tier-1
run can spread the two over its workers."""

import torch

from test_torch_train import _train_step_against_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


def test_train_step_with_the_appearance_tables_matches_jax(monkeypatch,
                                                           tmp_path):
    """One step of the port's train_step_fn against the JAX package's (as in
    test_torch_train) on test_torch_gradients' textured, environment-lit
    scene toward its image with the environment map halved: every table, the
    texture atlas, the environment map and the camera matrices among them,
    is updated as the JAX package updates it, and three steps of light_L,
    the atlas and the map lower the loss."""
    _train_step_against_jax("appearance", monkeypatch, tmp_path)
