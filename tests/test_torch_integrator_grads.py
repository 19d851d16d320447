"""The gradients of the integrators other than path and volpath:
`Renderer.value_and_grad` under direct lighting (one light a vertex, and
every light), Whitted, ambient occlusion and BDPT (a cotangent on the
film's rgb and on its t == 1 splats) against `jax.vjp` of the JAX
package's film step, with respect to the tables of its training step; mlt-
and sppm-named scenes, which `Renderer` estimates with the path
integrator, take path's gradients; the training step under BDPT and
direct lighting, and its divergence from the JAX package's step; and the
MLT and SPPM drivers, which have no gradient in the JAX package either.

The JAX side runs its step eagerly, batch by batch, with its walkers
jitted once and handed their inputs detached (test_torch_volpath
`_eager_jax`), on test_torch_direct's smoke scene (an area light over a
sphere and a floor; Whitted's with a glass sphere, a mirror and a point
light) at 16x16, depth 2. Tolerances: the film as test_torch_direct holds
it (99.5 % of the pixels within rtol 1e-4, atol 1e-5; the cotangent is
random on the agreeing pixels and 0 elsewhere), each table's gradient
within 1e-4 of its largest (GRAD_TOL; measured: at most 1.4e-5 of it,
BDPT's raster_to_camera, whose light subpaths' connections to the camera
sum many terms; direct lighting and Whitted at most 7.4e-7; AO's and the
matte scene's mat_ks and mat_roughness gradients are 0 in both packages).
BDPT's case is in test_torch_integrator_grads_bdpt.py, Whitted's and the
training step's in test_torch_integrator_grads_whitted.py, which share
this file's helpers (the JAX side of each case takes 20-60 s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.integrators.mlt as jmlt
import tpupt.integrators.sppm as jsppm
from tpupt.film.film import new_film as jax_new_film
from tpupt_torch.integrators.path import GRADIENT_INTEGRATORS, Renderer
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string

from test_torch_direct import pair, smoke_text
from test_torch_gradients import CORE, GRAD_TOL, _close_grads
from test_torch_volpath import _eager_jax

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

PIXEL_RTOL, PIXEL_ATOL, PIXELS_AGREE = 1e-4, 1e-5, 0.995
# case: (integrator, Integrator line's extra parameters, the specular scene)
CASES = {
    "directlighting_one": ("directlighting", '"string strategy" "one"',
                           False),
    "directlighting_all": ("directlighting", '"string strategy" "all"',
                           False),
    "whitted": ("whitted", "", True),
    "ambientocclusion": ("ambientocclusion", "", False),
    "bdpt": ("bdpt", "", False),
}


def _text(case, res=16, depth=2):
    integ, extra, specular = CASES[case]
    return smoke_text(integ, res=res, depth=depth, extra=extra,
                      specular=specular)


def _jax_films(rj, ds):
    f = jax_new_film(rj.cfg.xres, rj.cfg.yres)
    for b in range(rj.n_batches):
        f = rj._step_py(ds, f, jnp.uint32(0), rj._px_b[b], rj._py_b[b],
                        rj._valid_b[b])
    return f.rgb, f.splat


def _agree(a, b):
    return np.isclose(b, a, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)


@pytest.mark.parametrize("case", ["directlighting_one", "directlighting_all",
                                  "ambientocclusion"])
def test_integrator_gradients_match_jax(case, monkeypatch):
    """d/dtheta of sum(W_rgb * film.rgb + W_splat * film.splat) for random
    W on the pixels where both films agree, theta the training step's
    tables (mat_kd, mat_ks, mat_roughness, light_L and the camera
    matrices)."""
    integrator_gradients_match_jax(case, monkeypatch)


def integrator_gradients_match_jax(case, monkeypatch):
    """The comparison of `case` (see CASES)."""
    rj, rt = pair(_text(case))
    _eager_jax(rj, monkeypatch)
    names = CORE
    (fj, sj), vjp = jax.vjp(
        lambda p: _jax_films(rj, rj.ds._replace(**p)),
        {k: getattr(rj.ds, k) for k in names})
    film = rt.render(spp=1)
    n = film.weight.shape[0]
    ok = (_agree(np.asarray(fj).reshape(n, 3), film.rgb.numpy())
          & _agree(np.asarray(sj).reshape(n, 3), film.splat.numpy()))
    ok[-1] = False   # where the JAX film parks its masked lanes
    assert ok.mean() >= PIXELS_AGREE, f"{(~ok).sum()} pixels differ"
    gen = np.random.default_rng(3)
    w_rgb, w_splat = (
        (gen.uniform(0.2, 1.0, (n, 3)) * ok[:, None]).astype(np.float32)
        for _ in range(2))
    (gj,) = vjp((jnp.asarray(w_rgb.reshape(fj.shape)),
                 jnp.asarray(w_splat.reshape(sj.shape))))
    wr, ws = torch.from_numpy(w_rgb), torch.from_numpy(w_splat)
    vt, gt, film_vg = rt.value_and_grad(
        lambda f: (wr * f.rgb).sum() + (ws * f.splat).sum(),
        {k: getattr(rt.ds, k) for k in names})
    for f in ("rgb", "splat", "weight"):
        assert torch.equal(getattr(film_vg, f), getattr(film, f)), f
    want = float((np.asarray(fj).reshape(n, 3) * w_rgb).sum()
                 + (np.asarray(sj).reshape(n, 3) * w_splat).sum())
    np.testing.assert_allclose(float(vt), want, rtol=1e-5)
    _close_grads(gt, gj, case, tol=GRAD_TOL)
    if case == "ambientocclusion":
        # AO's radiance is visibility over the hemisphere: no table of the
        # training step moves it, in either package
        for k in names:
            assert not gt[k].any() and not np.asarray(gj[k]).any(), k
        return
    # the image is linear in light_L (the splats included)
    lin = float((gt["light_L"] * rt.ds.light_L).sum())
    np.testing.assert_allclose(lin, float(vt), rtol=1e-4)
    for k in ("mat_kd", "light_L", "cam_to_world"):
        assert float(gt[k].abs().max()) > 1e-4, k
    if case == "bdpt":
        assert float(film.splat.sum()) > 0
        # the splats carry gradient of their own
        _, g_splat, _ = rt.value_and_grad(
            lambda f: (ws * f.splat).sum(), {"light_L": rt.ds.light_L})
        assert float(g_splat["light_L"].abs().max()) > 1e-4


def test_mlt_and_sppm_scenes_take_path_gradients():
    """`Renderer` estimates an mlt- or sppm-named scene with path_li, as
    the JAX package's step does, so value_and_grad gives the path
    integrator's value and gradients, to the bit; every name `Renderer`
    renders is differentiated."""
    assert set(GRADIENT_INTEGRATORS) == {
        "path", "volpath", "directlighting", "whitted", "ambientocclusion",
        "bdpt", "mlt", "sppm"}
    w = torch.from_numpy(np.random.default_rng(4).uniform(
        0.2, 1.0, (64, 3)).astype(np.float32))
    out = {}
    for name in ("path", "mlt", "sppm"):
        r = Renderer(flatten(parse_string(smoke_text(name, res=8, depth=2))),
                     device="cpu")
        out[name] = r.value_and_grad(lambda f: (w * f.rgb).sum(),
                                     {k: getattr(r.ds, k) for k in CORE})
    v0, g0, _ = out["path"]
    assert float(v0) > 0
    for name in ("mlt", "sppm"):
        v, g, _ = out[name]
        assert torch.equal(v, v0), name
        for k in CORE:
            assert torch.equal(g[k], g0[k]), (name, k)


def test_mlt_and_sppm_drivers_have_no_gradient_in_jax():
    """The JAX package's MLT and SPPM drivers leave the trace through host
    numpy and Python scalars (tpupt/integrators/mlt.py: the bootstrap's
    luminances, b, the image; sppm.py: the overflow count, the image), so
    jax.value_and_grad of either `render` raises; the port's drivers add no
    gradient either. The drivers' device passes (MLT's path kernel, SPPM's
    camera and photon passes) are replaced by cheap functions of the light
    table: what raises is the drivers' own host code around them."""
    rj, _ = pair(smoke_text("mlt", res=4, depth=1))
    mr = jmlt.MLTRenderer(rj, n_bootstrap=64, n_chains=32)
    mr._eval = lambda ds, u, depth: (u[:, :3] * ds.light_L[0], u[:, 3:5])

    def mlt_loss(light_L):
        mr.r.ds = rj.ds._replace(light_L=light_L)
        return jnp.sum(mr.render(mutations_per_pixel=1))

    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.value_and_grad(mlt_loss)(rj.ds.light_L)

    rj, _ = pair(smoke_text("sppm", res=4, depth=1))
    sr = jsppm.SPPMRenderer(rj, photons_per_iter=64)
    n = rj.px.shape[0]
    sr._cam_jit = lambda ds, it: {"Ld": jnp.ones((n, 3)) * ds.light_L[0],
                                  "beta": jnp.ones((n, 3))}
    sr._ph_jit = lambda ds, it, vp, radius, lo, cell: (
        vp["Ld"], jnp.ones(n), jnp.zeros((), jnp.int32))

    def sppm_loss(light_L):
        sr.r.ds = rj.ds._replace(light_L=light_L)
        return jnp.sum(sr.render(n_iterations=1))

    with pytest.raises(jax.errors.TracerArrayConversionError):
        jax.value_and_grad(sppm_loss)(rj.ds.light_L)
