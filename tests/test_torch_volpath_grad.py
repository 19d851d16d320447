"""`Renderer.value_and_grad` of the volumetric path integrator with respect
to every float medium table (med_sigma_a, med_sigma_s, med_g,
med_majorant, med_density, med_w2m) beside mat_kd, light_L and the camera
matrices, against `jax.vjp` of the JAX package's film step, on
test_torch_volpath's grid scene (a 4^3 grid medium the camera sits in: its
transmittance's gradient goes through K6's backward, `tr_grid_backward_plain`
on the CPU, and reaches the camera through the rays' origins and
directions) and its global homogeneous fog.

The JAX side runs its step eagerly with its volpath loop a Python loop and
its walkers jitted once and handed their inputs detached
(test_torch_volpath `_eager_jax`): jax.grad of it then is the
detached-sampling estimator the port computes. Its grid loops' two pure
helpers, the trilinear lookup and the hash's uniform, are jitted once
each (`_jitted_tracking_helpers`): the same functions, one dispatch a call
instead of some sixty (the grid case's JAX side took 57 s eagerly, 37 s
so). Tolerances: the film as
test_torch_volpath holds it (99 % of the pixels within rtol 1e-4, atol
1e-5; the cotangent is 1 on the agreeing pixels and 0 elsewhere), each
table's gradient within 1e-4 of its largest (GRAD_TOL; measured: at most
8.9e-7 of it, the global fog's med_sigma_s; the grid scene's at most
3.1e-7)."""

import functools

import jax
import numpy as np
import pytest
import torch

from tpupt.core import rng as jax_rng
from tpupt.media import media as jax_media

from test_torch_gradients import GRAD_TOL, _close_grads
from test_torch_volpath import _eager_jax, _films_agree, _jax_film, _pair

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

MEDIUM_KEYS = ("med_sigma_a", "med_sigma_s", "med_g", "med_majorant",
               "med_density", "med_w2m")
OTHER_KEYS = ("mat_kd", "light_L", "raster_to_camera", "cam_to_world")
# the tables a homogeneous medium does not read
GRID_ONLY = ("med_majorant", "med_density", "med_w2m")


@functools.lru_cache(maxsize=None)
def _jitted_tracking_helpers():
    return (jax.jit(jax_media._grid_density_lane),
            jax.jit(jax_rng.uniform_float))


@pytest.mark.parametrize("name", ["grid", "global_fog"])
def test_medium_table_gradients_match_jax(name, monkeypatch):
    sj, rj, sp, rt = _pair(name)
    assert rt.st.any_grid_media == (name == "grid")
    _eager_jax(rj, monkeypatch)
    lookup, uniform = _jitted_tracking_helpers()
    monkeypatch.setattr(jax_media, "_grid_density_lane", lookup)
    monkeypatch.setattr(jax_rng, "uniform_float", uniform)
    names = MEDIUM_KEYS + OTHER_KEYS

    def jax_film(params):
        return _jax_film(rj, rj.ds._replace(**params)).rgb

    fj, vjp = jax.vjp(jax_film, {k: getattr(rj.ds, k) for k in names})
    n = sj.film.xres * sj.film.yres
    ok = _films_agree(np.asarray(fj).reshape(n, 3),
                      rt.render(spp=1).rgb.numpy().reshape(n, 3))
    w = np.broadcast_to(ok[:, None], (n, 3)).astype(np.float32).reshape(
        fj.shape)
    (gj,) = vjp(jax.numpy.asarray(w))
    wt = torch.from_numpy(w)
    vt, gt, _ = rt.value_and_grad(lambda f: (wt * f.rgb).sum(),
                                  {k: getattr(rt.ds, k) for k in names})
    np.testing.assert_allclose(float(vt), float((np.asarray(fj) * w).sum()),
                               rtol=1e-5)
    _close_grads(gt, gj, f"volpath {name}", tol=GRAD_TOL)
    for k in names:
        if name == "grid" or k not in GRID_ONLY:
            assert float(gt[k].abs().max()) > 0.0, k
        else:
            assert not gt[k].any() and not np.asarray(gj[k]).any(), k
    # the film is linear in light_L
    lin = float((gt["light_L"] * rt.ds.light_L).sum())
    np.testing.assert_allclose(lin, float(vt), rtol=1e-4)
