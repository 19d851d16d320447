"""The volumetric path integrator of the PyTorch port against the JAX
package's, on the same tables (carried across with `from_numpy`) and the
same sampler: films of a global fog, a fog sphere behind a null interface,
a grid medium and a spectral fog sphere at 16x16, the gradients of the
global fog's film with respect to mat_kd and light_L against `jax.vjp`
(a medium table's too: test_torch_volpath_grad.py holds every medium
table's gradient against `jax.vjp`), and the
training-step divergence (the JAX package's step renders every scene with
its path integrator and compares the raw radiance, so media do not change
its loss and bad samples stay in it; the port's step takes the film's
estimator).

The JAX side renders through its own jitted renderer, except where its
grid loops (64 and 32 unrolled steps a call) would take minutes to
compile and for the gradients: there it runs its step eagerly, its volpath
loop as a Python loop and its XLA walkers jitted once per scene.
Tolerances, measured: per pixel rtol 1e-4, atol 1e-5 as the path
integrator's film parity (test_torch_render); a sample whose medium
decision falls the other way on a last-bit difference of a log or exp
changes its pixel: 1 pixel of 255 in the global fog, none in the others
(held: 99 % of the pixels). The film gradients differ from JAX's by at most
2e-6 of each table's largest (held to 1e-4, test_torch_gradients'
GRAD_TOL)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.integrators.volpath as jax_volpath
from tpupt.film.film import new_film as jax_new_film
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.parallel import mesh as jax_mesh
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.parallel.mesh import train_step_fn
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

from test_torch_gradients import GRAD_TOL, _close_grads, _jax_walkers
from test_torch_spectral_render import (_OUT_OF_GAMUT, _raw_radiance,
                                        step_loss)

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

PIXEL_RTOL, PIXEL_ATOL, PIXELS_AGREE = 1e-4, 1e-5, 0.99

_BASE = """
LookAt 0 0 5   0 0 0   0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [1]
Integrator "volpath" "integer maxdepth" [%(depth)d]
WorldBegin
%(media)s
LightSource "point" "point from" [3 1 4] "color I" [40 40 40]
Material "matte" "color Kd" [0.7 0.5 0.3]
Shape "trianglemesh" "point P" [ -50 -50 0  50 -50 0  50 50 0  -50 50 0 ]
    "integer indices" [0 1 2 2 3 0]
%(ball)s
WorldEnd
"""
_FOG = ('MakeNamedMedium "fog" "string type" "homogeneous" '
        '"color sigma_a" [0.05 0.08 0.1] "color sigma_s" [0.2 0.15 0.1] '
        '"float g" [0.3]')
_BALL = """AttributeBegin
Material "none"
MediumInterface "fog" ""
Translate 0.3 0 2.5
Shape "sphere" "float radius" [1]
AttributeEnd"""
_GRID = ('MakeNamedMedium "smoke" "string type" "heterogeneous" '
         '"color sigma_a" [0.5 0.5 0.5] "color sigma_s" [2 2 2] '
         '"integer nx" [4] "integer ny" [4] "integer nz" [4] '
         '"point p0" [-1 -1 1] "point p1" [1 1 3] "float density" [%s]'
         % " ".join(f"{v:.3f}" for v in np.random.default_rng(1).random(64)))

# name: (media lines, interface lines, depth, spectral)
SCENES = {
    # its film is compared in the gradient test
    "global_fog": (_FOG, "", 3, False),
    "fog_sphere": (_FOG, _BALL, 2, False),
    "grid": (_GRID, "", 1, False),
    "spectral_fog_sphere": (_FOG, _BALL, 3, True),
}


def _text(name):
    media, ball, depth, _ = SCENES[name]
    return _BASE % dict(media=media, ball=ball, depth=depth)


def _pair(name, text=None):
    """(jax scene, jax Renderer, port scene, port Renderer) on one table
    set, spectral where the case is."""
    txt = text or _text(name)
    spectral = SCENES[name][3] if name in SCENES else False
    sj = jax_flatten(jax_parse_string(txt))
    rj = JaxRenderer(sj, spectral=spectral)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    sp = flatten(parse_string(txt))
    return sj, rj, sp, Renderer(sp, device="cpu", tables=tables)


def _eager_jax(rj, monkeypatch):
    """The JAX renderer's step runs eagerly: its volpath loop a Python
    loop (the same iterations in order), its walkers jitted once and handed
    their inputs detached. Its volpath_li passes the differentiated tables
    to its traversal as they are (tpupt/integrators/volpath.py:172,218),
    where path_li stops their gradient, so jax.grad of it raises on the
    walker's while_loop; detached, it is the estimator path_li uses."""
    def fori_loop(lo, hi, body, init):
        for i in range(lo, hi):
            init = body(i, init)
        return init
    monkeypatch.setattr(jax_volpath, "jax", types.SimpleNamespace(
        lax=types.SimpleNamespace(fori_loop=fori_loop)))
    stop = functools.partial(jax.tree.map, jax.lax.stop_gradient)
    rj._isect, rj._isect_p = (
        lambda ds, st, *a, _w=w, **k: jax.tree.map(
            jax.lax.stop_gradient, _w(stop(ds), st, *stop(a), **k))
        for w in _jax_walkers(rj.st))


def _jax_film(rj, ds=None):
    f = jax_new_film(rj.cfg.xres, rj.cfg.yres)
    for b in range(rj.n_batches):
        f = rj._step_py(rj.ds if ds is None else ds, f, jnp.uint32(0),
                        rj._px_b[b], rj._py_b[b], rj._valid_b[b])
    return f


@pytest.mark.parametrize("name", [k for k in SCENES if k != "global_fog"])
def test_film_matches_jax_volpath(name, monkeypatch):
    sj, rj, sp, rt = _pair(name)
    st = rt.st
    assert st.n_media == 1 and st.n_channels == (60 if SCENES[name][3]
                                                  else 3)
    assert st.has_med_interfaces == bool(SCENES[name][1])
    assert st.any_grid_media == (name == "grid")
    if name == "grid":
        _eager_jax(rj, monkeypatch)
        fj = _jax_film(rj)
    else:
        fj = rj.render(spp=1)
    ft = rt.render(spp=1)
    n = sj.film.xres * sj.film.yres
    b = ft.rgb.numpy().reshape(n, 3)
    assert np.isfinite(b).all() and b.mean() > 0.01
    _films_agree(np.asarray(fj.rgb).reshape(n, 3), b)
    np.testing.assert_allclose(ft.weight.numpy().reshape(n),
                               np.asarray(fj.weight).reshape(n)[...],
                               rtol=1e-6, atol=1e-6)
    # the media are seen: the scene without them renders otherwise
    rc = Renderer(flatten(parse_string(_BASE % dict(
        media="", ball="", depth=SCENES[name][2]))), device="cpu")
    assert not np.allclose(rc.image(rc.render(spp=1)), rt.image(ft),
                           rtol=1e-2, atol=1e-3)


def _films_agree(a, b):
    """Per-pixel agreement of two (n, 3) films but the last pixel (where
    the JAX film parks its masked lanes); returns the agreeing pixels."""
    ok = np.isclose(b, a, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    ok[-1] = False
    assert ok[:-1].mean() >= PIXELS_AGREE, f"{(~ok[:-1]).sum()} differ"
    return ok


def test_global_fog_film_and_gradients_match_jax(monkeypatch):
    """The global fog: the film, and the gradients of the sum of its
    agreeing pixels (a medium decision that falls the other way on a last
    bit changes a pixel, and its gradient: left out, as test_torch_gradients
    leaves such rays out) with respect to mat_kd and light_L against
    jax.vjp of the JAX package's film step (eager); the film is linear in
    light_L; a med_* key gives a finite gradient of the same loss. (The
    fog sphere's interfaces take seven
    loop iterations of five traversals each, four times the eager JAX
    side's time; the port's replay of them is checked on the card,
    chip_smoke.py's fog museum.)"""
    sj, rj, sp, rt = _pair("global_fog")
    assert not rt.st.has_med_interfaces and not rt.st.any_grid_media
    _eager_jax(rj, monkeypatch)
    names = ("mat_kd", "light_L")

    def jax_film(params):
        return _jax_film(rj, rj.ds._replace(**params)).rgb

    fj, vjp = jax.vjp(jax_film, {k: getattr(rj.ds, k) for k in names})
    n = sj.film.xres * sj.film.yres
    ok = _films_agree(np.asarray(fj).reshape(n, 3),
                      rt.render(spp=1).rgb.numpy().reshape(n, 3))
    w = np.broadcast_to(ok[:, None], (n, 3)).astype(np.float32).reshape(
        fj.shape)
    (gj,) = vjp(jnp.asarray(w))
    wt = torch.from_numpy(w)
    vt, gt, _ = rt.value_and_grad(lambda f: (wt * f.rgb).sum(),
                                  {k: getattr(rt.ds, k) for k in names})
    np.testing.assert_allclose(float(vt), float(jnp.sum(fj * w)), rtol=1e-5)
    _close_grads(gt, gj, "volpath film", tol=GRAD_TOL)
    assert float(gt["mat_kd"].abs().max()) > 1e-3
    lin = float((gt["light_L"] * rt.ds.light_L).sum())
    np.testing.assert_allclose(lin, float(vt), rtol=1e-4)
    # a med_* key differentiates too (held against jax.vjp in
    # test_torch_volpath_grad.py): the same loss, a finite gradient
    vm, gm, _ = rt.value_and_grad(lambda f: (wt * f.rgb).sum(),
                                  {"med_sigma_s": rt.ds.med_sigma_s})
    assert torch.equal(vm, vt)
    assert bool(torch.isfinite(gm["med_sigma_s"]).all())
    assert float(gm["med_sigma_s"].abs().max()) > 0


def test_train_step_divergence_on_a_fog_scene(monkeypatch):
    """The JAX package's train_step_fn renders with path_li whatever the
    integrator (tpupt/parallel/mesh.py:201) and compares the raw radiance
    with its target; the port's step takes the film's estimator. On
    test_torch_spectral_render's out-of-gamut colours in a global fog,
    under spectral transport (the JAX step made spectral): the JAX loss is
    the loss of the raw path_li radiance of the scene without its fog, bad
    samples (luminance below -1e-5) and all; the port's loss is that of
    volpath's radiance with the bad samples black."""
    fog_txt = _OUT_OF_GAMUT.replace('Integrator "path"',
                                    'Integrator "volpath"').replace(
        "WorldBegin", "WorldBegin\n" + _FOG)
    target = np.full((8, 8, 3), 0.25, np.float32)
    monkeypatch.setattr(jax_mesh, "pick_traversal", _jax_walkers)
    monkeypatch.setattr(
        jax_mesh, "path_li",
        lambda ds, st, *a, **k: jax_path_li(ds, st._replace(n_channels=60),
                                            *a, unroll=True, **k))
    jstep, jp0, (px, py, valid) = jax_mesh.train_step_fn(
        jax_flatten(jax_parse_string(fog_txt)),
        jax_mesh.make_mesh(jax.devices()[:1]), target)
    loss_j = float(jstep(jp0, jnp.uint32(0), px, py, valid, 0.0)[0])

    sp = flatten(parse_string(fog_txt))
    step, p0 = train_step_fn(sp, None, target, device="cpu", spectral=True)
    r = Renderer(sp, device="cpu", spectral=True)
    assert r.st.n_media == 1 and r.n_batches == 1
    loss_fog = float(step(p0, 0, 0.0)[0])
    np.testing.assert_allclose(
        loss_fog, step_loss(r, r._radiance(r.ds, 0, 0)[1], target),
        rtol=1e-6)
    clear = Renderer(flatten(parse_string(_OUT_OF_GAMUT)), device="cpu",
                     spectral=True)
    raw, clamped = _raw_radiance(clear, 0)
    np.testing.assert_allclose(loss_j, step_loss(clear, raw, target),
                               rtol=1e-5)
    assert abs(loss_j - step_loss(clear, clamped, target)) > 1e-3
    assert abs(loss_fog - loss_j) > 1e-2 * loss_j
