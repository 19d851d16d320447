"""Film-level gradients and the training step of the PyTorch port against
the JAX package's, on the same tables and sampler: `Renderer.value_and_grad`
against `jax.value_and_grad` of the JAX package's film step, and one step
of `parallel.mesh.train_step_fn` against its `train_step_fn` on a
one-device CPU mesh. The JAX side runs eagerly, as in
test_torch_gradients.py (whose helpers and tolerances this file shares;
the textured scene's and the materials museum's cases are in
test_torch_train_appearance.py, test_torch_train_appearance_step.py and
test_torch_train_materials.py):
the film-level gradients differ from `jax.grad`'s by at most 3.5e-6 of the
largest absolute gradient of each table, the training step's update,
compared as (p - p_new) / lr, by at most 4.2e-6; both are held to 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.film.film import new_film as jax_new_film
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.parallel import mesh as jax_mesh
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import PARAMS, train_step_fn
from tpupt_torch.scene.flatten import MAT_HAIR

from test_torch_gradients import (APPEARANCE, BENCH, CORE, GRAD_TOL,
                                  _close_grads, _jax_walkers, _pair, _params,
                                  eager_fourier_loops)

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


@pytest.mark.parametrize("loss", ["sum", "weighted"])
def test_film_gradients_match_jax(loss, tmp_path, monkeypatch):
    """`Renderer.value_and_grad` at 1 spp against `jax.value_and_grad` of
    the same loss of the JAX package's film step (`film_gradients_match_jax`
    says which); the "appearance" and "materials" cases are in
    test_torch_train_appearance.py and test_torch_train_materials.py."""
    film_gradients_match_jax(loss, tmp_path, monkeypatch)


def film_gradients_match_jax(loss, tmp_path, monkeypatch):
    """The film-level comparison of one loss. "sum": the bench's loss,
    sum(film.rgb), with respect to its four tables, on a 16x16 museum (the
    camera matrices' gradient there is carried by lanes of radiance about
    1e-14, grazing samples of its area light where a last-bit difference
    flips a threshold, so both packages' are noise). "weighted": a fixed
    random weighting of the pixels, with respect to all six tables, on the
    dry-run scene at 32x32. "appearance": sum(film.rgb) on
    test_torch_gradients' textured, environment-lit scene with respect to
    the texture atlas, the environment map, light_L, roughness and the
    camera matrices (its Kd and Ks are all textures). "materials":
    sum(film.rgb) on test_torch_gradients' small materials museum with
    respect to the bench's four tables (mat_kd on the rows where the JAX
    package's is not NaN, test_torch_gradients_materials.
    test_hair_lobes_of_other_lanes_make_the_jax_kd_gradient_nan). The film
    is linear in the emitters, light_L and env_map jointly (the pdfs, the
    env map's sampling tables and the light grid are upload-time
    constants), so sum(light_L * dloss/dlight_L) + sum(env_map *
    dloss/denv_map) equals the loss."""
    eager_fourier_loops(monkeypatch)
    scene = {"sum": "museum", "weighted": "dryrun"}.get(loss, loss)
    sj, rj, sp, rt = _pair(scene, tmp_path)
    rj._isect, rj._isect_p = _jax_walkers(rj.st)
    rj._unroll = True
    names = {"sum": BENCH, "weighted": CORE, "materials": BENCH}.get(
        loss, ("mat_roughness", "light_L", "raster_to_camera",
               "cam_to_world") + APPEARANCE)
    w = np.random.default_rng(3).uniform(
        0.2, 1.0, (sj.film.xres * sj.film.yres, 3)).astype(np.float32)
    if loss != "weighted":
        w[:] = 1.0

    def jax_loss(params):
        ds = rj.ds._replace(**params)
        f = jax_new_film(sj.film.xres, sj.film.yres)
        for i in range(rj.n_batches):
            f = rj._step_py(ds, f, jnp.uint32(0), rj._px_b[i], rj._py_b[i],
                            rj._valid_b[i])
        return jnp.sum(jnp.asarray(w) * f.rgb)

    vj, gj = jax.value_and_grad(jax_loss)(_params(rj.ds, names))
    wt = torch.from_numpy(w)
    vt, gt, film = rt.value_and_grad(lambda f: torch.sum(wt * f.rgb),
                                     _params(rt.ds, names))
    np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5)
    if loss == "materials":
        kd_j = np.asarray(gj.pop("mat_kd"))
        finite = np.isfinite(kd_j).all(-1)
        assert not finite.all() and finite[rt.ds.mat_type.numpy()
                                           == MAT_HAIR].all()
        assert torch.isfinite(gt["mat_kd"]).all()
        _close_grads({"mat_kd": gt["mat_kd"][torch.from_numpy(finite)]},
                     {"mat_kd": kd_j[finite]}, "film, materials")
    _close_grads(gt, gj, f"film, {loss}")
    for k in names:
        assert float(gt[k].abs().max()) > 0.0, k
    lin = float((gt["light_L"] * rt.ds.light_L).sum())
    if "env_map" in names:
        lin += float((gt["env_map"] * rt.ds.env_map).sum())
    np.testing.assert_allclose(lin, float(vt), rtol=1e-4)


def _kd_target(sp, rt):
    """The image of the scene with every diffuse albedo halved, 1 spp."""
    ds = rt.ds._replace(mat_kd=rt.ds.mat_kd * 0.5)
    r = Renderer(sp, device="cpu", tables=(ds, rt.st))
    return r.image(r.render(spp=1))


def test_train_step_matches_jax_and_lowers_the_loss(monkeypatch):
    """One step of the port's train_step_fn against the JAX package's on a
    one-device CPU mesh (its walkers jitted, its bounce loop unrolled), same
    loss and same updated tables; then three steps of the port lower the
    loss."""
    _train_step_against_jax("two_materials", monkeypatch, None)


def _train_step_against_jax(scene, monkeypatch, tmp_path):
    sj, rj, sp, rt = _pair(scene, tmp_path)
    if scene == "appearance":
        ds = rt.ds._replace(env_map=rt.ds.env_map * 0.5)
        r = Renderer(sp, device="cpu", tables=(ds, rt.st))
        target = r.image(r.render(spp=1))
        names, train = PARAMS, ("light_L",) + APPEARANCE
    else:
        target = _kd_target(sp, rt)
        names, train = PARAMS, BENCH
    tables = (rt.ds, rt.st)
    step, p0 = train_step_fn(sp, None, target, device="cpu", tables=tables)
    assert set(p0) == set(PARAMS)
    lr = 1e-3
    loss_t, new_t = step(p0, 0, lr)

    monkeypatch.setattr(jax_mesh, "pick_traversal", _jax_walkers)
    monkeypatch.setattr(jax_mesh, "path_li",
                        functools.partial(jax_path_li, unroll=True))
    jstep, jp0, (px, py, valid) = jax_mesh.train_step_fn(
        sj, jax_mesh.make_mesh(jax.devices()[:1]), target)
    jp0 = {k: jp0[k] for k in PARAMS}
    loss_j, new_j = jstep.__wrapped__(jp0, jnp.uint32(0), px, py, valid, lr)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    # the update: p0 - lr * g; compare the steps lr * g themselves
    steps_t = {k: (p0[k] - new_t[k]) / lr for k in names}
    steps_j = {k: (np.asarray(jp0[k]) - np.asarray(new_j[k])) / lr
               for k in names}
    if scene == "appearance":
        # p0 - lr * g is rounded to float32, so a step is known to within
        # one ulp of the parameter over lr: 6e-5 for the camera matrices'
        # entries of 0.5-1 at lr 1e-3, above GRAD_TOL of their largest step
        # here (3.6e-5). Their steps are held to that on top of GRAD_TOL
        # (measured: one ulp exactly); test_torch_gradients compares their
        # gradients themselves at GRAD_TOL
        for k in ("raster_to_camera", "cam_to_world"):
            gt, gj = steps_t.pop(k).numpy(), steps_j.pop(k)
            ulp = float(np.spacing(np.abs(p0[k].numpy())).max()) / lr
            err = float(np.abs(gt - gj).max())
            assert err <= GRAD_TOL * float(np.abs(gj).max()) + ulp, (k, err)
    _close_grads(steps_t, steps_j, "train step")

    params = {k: p0[k] for k in train}
    losses = []
    for _ in range(3):
        loss, params = step(params, 0, 0.5)
        losses.append(float(loss))
    assert losses[2] < losses[0], losses
