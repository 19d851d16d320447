"""Whitted's gradients against `jax.vjp` of the JAX package's film step
(test_torch_integrator_grads.py's comparison, scene and tolerances), and
the training step under BDPT and direct lighting.

The port's training step takes each integrator's per-ray radiance from
`Renderer._radiance`; under BDPT that leaves out the t == 1 strategies,
which splat onto other pixels and have no camera ray of their own. The
JAX package's step renders with path_li whatever the integrator and
compares that radiance (tpupt/parallel/mesh.py `render_L`): the
divergence is pinned against its loss function, run once eagerly (its
jitted step takes minutes to compile on the CPU)."""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.integrators.path import path_li as jax_path_li
from tpupt.parallel import mesh as jax_mesh
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import train_step_fn
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string

from test_torch_gradients import _jax_walkers
from test_torch_integrator_grads import _text, integrator_gradients_match_jax
from test_torch_spectral_render import step_loss

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


def test_whitted_gradients_match_jax(monkeypatch):
    integrator_gradients_match_jax("whitted", monkeypatch)


@functools.lru_cache(maxsize=None)
def _jax_step_loss(target_bytes):
    """The JAX package's training step's loss on the smoke scene (its step
    renders with path_li whatever the integrator: one scene serves both
    cases), its walkers jitted once, its path_li unrolled (as on the
    TPU)."""
    target = np.frombuffer(target_bytes, np.float32).reshape(8, 8, 3)
    sj = jax_flatten(jax_parse_string(_text("bdpt", res=8, depth=1)))
    saved = jax_mesh.pick_traversal, jax_mesh.path_li
    try:
        jax_mesh.pick_traversal = _jax_walkers
        jax_mesh.path_li = functools.partial(jax_path_li, unroll=True)
        jstep, jp0, (px, py, valid) = jax_mesh.train_step_fn(
            sj, jax_mesh.make_mesh(jax.devices()[:1]), target)
        # the loss the jitted step differentiates, run eagerly
        render_L = inspect.getclosurevars(
            jstep.__wrapped__).nonlocals["render_L"]
        return float(render_L(jp0, jnp.uint32(0), px, py, valid))
    finally:
        jax_mesh.pick_traversal, jax_mesh.path_li = saved


@pytest.mark.parametrize("integ", ["bdpt", "directlighting"])
def test_train_step_under_other_integrators(integ):
    """The port's training step takes the scene's integrator's per-ray
    radiance (`Renderer._radiance`); under BDPT that leaves out the t == 1
    strategies, which splat onto other pixels and have no camera ray: its
    loss is that of the camera rays' radiance alone. The JAX package's step
    renders with path_li whatever the integrator, so its loss is the path
    integrator's (the divergence, pinned): a step lowers the loss, and its
    gradients are finite."""
    target = np.full((8, 8, 3), 0.3, np.float32)
    case = "bdpt" if integ == "bdpt" else "directlighting_all"
    sp = flatten(parse_string(_text(case, res=8, depth=1)))
    step, p0 = train_step_fn(sp, None, target, device="cpu")
    p0 = {k: p0[k] for k in ("mat_kd", "light_L")}
    r = Renderer(sp, device="cpu")
    assert r.n_batches == 1
    _, L, *rest = r._radiance(r.ds, 0, 0)
    loss, new = step(p0, 0, 1e-3)
    np.testing.assert_allclose(float(loss), step_loss(r, L, target),
                               rtol=1e-6)
    moved = {k: float((new[k] - p0[k]).abs().max()) for k in p0}
    assert all(np.isfinite(v) for v in moved.values())
    assert moved["mat_kd"] > 0 and moved["light_L"] > 0
    loss2, _ = step(new, 0, 0.0)
    assert float(loss2) < float(loss)
    if integ == "bdpt":
        sp_p, sp_L = rest[1]
        assert float(sp_L.abs().sum()) > 0   # splats the step leaves out
    rp = Renderer(flatten(parse_string(_text(case, res=8, depth=1).replace(
        f'Integrator "{integ}"', 'Integrator "path"'))), device="cpu")
    loss_path = step_loss(rp, rp._radiance(rp.ds, 0, 0)[1], target)
    loss_j = _jax_step_loss(target.tobytes())
    np.testing.assert_allclose(loss_j, loss_path, rtol=1e-5)
    assert abs(float(loss) - loss_j) > 1e-3 * loss_j
