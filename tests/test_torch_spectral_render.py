"""Spectral transport through the path integrator of the PyTorch port
against the JAX package's `Renderer(spectral=True)`, on the same tables
(carried across with `from_numpy`): the films of the spectral museum
(tools/testscenes.py: saturated rows under a blackbody light) and of a
Disney / Fourier scene, the per-ray and per-film gradients with respect to
mat_kd and light_L against `jax.grad`, the bad-sample divergence, and the
CLI's --spectral.

The bad-sample divergence: the film (`integrator.cpp:300-321`) turns a
sample with a non-finite channel or a luminance below -1e-5 black, in both
packages; the JAX package's training step compares the raw radiance with
its target, the port's step the film's. The uplift's basis spectra are
nonnegative (to 6e-6), so products of colours inside the RGB gamut keep a
nonnegative luminance; the scene that shows the divergence takes a diffuse
colour and a light given in XYZ outside the gamut (their RGB have negative
channels), whose spectral products have negative luminance.

The JAX side renders through its own jitted renderer for the films and
its own jitted training step; for the gradients it runs eagerly with its
bounce loop unrolled and its XLA walkers jitted once (test_torch_gradients).
Tolerances, measured: films per pixel as the RGB film parity
(test_torch_render: rtol 1e-4, atol 1e-5 on 99.5 % of the pixels; all
agree here); gradients within 3e-6 of each table's largest (held to
GRAD_TOL, 1e-4); the radiance per ray within RAY_RTOL / RAY_ATOL."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.core.spectrum import luminance
from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators import path as tpath
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.materials.fourier import write_bsdf_file
from tpupt_torch.parallel.mesh import train_step_fn
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import render as render_cli
from tpupt_torch.tools import testscenes
from tpupt_torch.utils.imageio import read_pfm

from test_torch_gradients import (GRAD_TOL, RAY_ATOL, RAY_RTOL, SCENES,
                                  _adjust, _close_grads, _jax_walkers)

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

NAMES = ("mat_kd", "light_L")

_FOURIER_DISNEY = """
LookAt 0 -4 2  0 0 0.5  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [1]
WorldBegin
AttributeBegin
AreaLightSource "diffuse" "blackbody L" [3200 12]
Shape "trianglemesh" "point P" [-1 -1 3.1  1 -1 3.1  1 1 3.1  -1 1 3.1]
  "integer indices" [0 2 1 0 3 2]
AttributeEnd
Material "fourier" "string bsdffile" ["statue.bsdf"]
Shape "trianglemesh" "point P" [-4 -4 0  4 -4 0  4 4 0  -4 4 0]
  "integer indices" [0 1 2 0 2 3]
Material "disney" "rgb color" [0.8 0.1 0.05] "float metallic" [0.3]
  "float roughness" [0.3] "float clearcoat" [0.6] "float sheen" [0.4]
Translate -0.4 0.3 0.7
Shape "sphere" "float radius" [0.7]
WorldEnd
"""

# a diffuse colour and a light outside the RGB gamut (XYZ with x or z
# near 1 and y near 0): their spectral products have negative luminance
_OUT_OF_GAMUT = """
LookAt 0 -4 2  0 0 0.5  0 0 1
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Sampler "halton" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [1]
WorldBegin
LightSource "distant" "point from" [1 -2 4] "point to" [0 0 0]
  "xyz L" [0.35 3.4 3.8]
Material "matte" "xyz Kd" [0.95 0.01 0.2]
Shape "trianglemesh" "point P" [-4 -4 0  4 -4 0  4 4 0  -4 4 0]
  "integer indices" [0 1 2 0 2 3]
Material "matte" "rgb Kd" [0.2 0.6 0.3]
Shape "trianglemesh" "point P" [-0.6 -0.5 0.01  0.6 -0.5 0.01  0 0.4 1.2]
  "integer indices" [0 1 2]
WorldEnd
"""


def _scenes(name, tmp):
    """(jax FlatScene, port FlatScene) of `name`."""
    if name == "museum":
        path = testscenes.spectral_museum(str(tmp), grid=2, seg=8, rings=4)
        d = os.path.dirname(path)
        pair = (jax_flatten(jax_parse_file(path), d),
                flatten(parse_file(path), d))
        return tuple(_adjust(s, 2, 16) for s in pair)
    if name == "fourier_disney":
        write_bsdf_file(str(tmp / "statue.bsdf"),
                        testscenes.fourier_test_table())
        path = tmp / "fourier_disney.pbrt"
        path.write_text(_FOURIER_DISNEY)
        return (jax_flatten(jax_parse_file(str(path)), str(tmp)),
                flatten(parse_file(str(path)), str(tmp)))
    txt = {"out_of_gamut": _OUT_OF_GAMUT}.get(name)
    if txt is None:   # test_torch_gradients' scenes
        txt, depth, res = SCENES[name]
        return (_adjust(jax_flatten(jax_parse_string(txt)), depth, res),
                _adjust(flatten(parse_string(txt)), depth, res))
    return jax_flatten(jax_parse_string(txt)), flatten(parse_string(txt))


def _pair(name, tmp):
    sj, sp = _scenes(name, tmp)
    rj = JaxRenderer(sj, spectral=True)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    rt = Renderer(sp, device="cpu", tables=tables)
    assert rj.st.n_channels == rt.st.n_channels == 60
    return sj, rj, sp, rt


def _raw_radiance(rt, b):
    """The port's per-ray radiance of batch b before the film's clamp."""
    seen = {}
    real = tpath.path_li

    def spy(*a, **k):
        out = real(*a, **k)
        seen["L"] = out[0]
        return out
    try:
        tpath.path_li = spy
        _, clamped, _ = rt._radiance(rt.ds, 0, b)
    finally:
        tpath.path_li = real
    return seen["L"], clamped


@pytest.mark.parametrize("name", ["museum", "fourier_disney"])
def test_spectral_film_matches_jax(name, tmp_path):
    sj, rj, sp, rt = _pair(name, tmp_path)
    if name == "fourier_disney":
        assert {"fourier", "disney"} <= rt.st.mat_features
    fj = rj.render(spp=1)
    ft = rt.render(spp=1)
    n = sj.film.xres * sj.film.yres
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    a = np.asarray(fj.rgb).reshape(n, 3)
    b = ft.rgb.numpy().reshape(n, 3)
    assert np.isfinite(b).all() and b.mean() > 1e-3
    ok = np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    # spectral transport is not RGB transport on these saturated colours
    rgb = Renderer(sp, device="cpu")
    assert rgb.st.n_channels == 3
    assert not np.allclose(rgb.image(rgb.render(spp=1)), rt.image(ft),
                           rtol=1e-3, atol=1e-4)


def test_spectral_gradients_match_jax(tmp_path):
    """Per ray: d/dtheta of sum(W * L) over path_li's spectral radiance of
    the two-material scene; per film: value_and_grad of sum(film.rgb) of
    the same scene against jax.value_and_grad of the JAX package's film
    step; both with respect to mat_kd and light_L."""
    sj, rj, sp, rt = _pair("two_materials", tmp_path)
    isect, isect_p = _jax_walkers(rj.st)
    integ = sj.integrator
    n = rt.batch
    assert rt.n_batches == rj.n_batches == 1

    def jax_L(params):
        ds = rj.ds._replace(**params)
        jx, jy = rj.sampler.camera_jitter(rj.px, rj.py, jnp.uint32(0))
        pr = jnp.stack([rj.px.astype(jnp.float32) + jx,
                        rj.py.astype(jnp.float32) + jy], -1)
        o, d = jax_generate_rays(sj.camera.type, ds.raster_to_camera,
                                 ds.cam_to_world, pr, jnp.zeros((n, 2)),
                                 sj.camera.lens_radius,
                                 sj.camera.focal_distance)
        L, _ = jax_path_li(ds, rj.st, rj.sampler, integ.max_depth,
                           integ.rr_threshold, rj.px, rj.py, jnp.uint32(0),
                           o, d, isect=isect, isect_p=isect_p, unroll=True)
        return jnp.where(rj.valid[:, None], L, 0.0)

    Lj, vjp = jax.vjp(jax_L, {k: getattr(rj.ds, k) for k in NAMES})
    leaves = {k: getattr(rt.ds, k).clone().requires_grad_() for k in NAMES}
    _, Lt, _ = rt._radiance(rt.ds._replace(**leaves), 0, 0)
    Lt = torch.where(rt._valid_b[0][:, None], Lt, 0.0)
    agree = np.isclose(Lt.detach().numpy(), np.asarray(Lj), rtol=RAY_RTOL,
                       atol=RAY_ATOL).all(-1)
    assert agree.all(), f"{(~agree).sum()} rays differ"
    w = np.random.default_rng(0).uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    (gj,) = vjp(jnp.asarray(w))
    gt = dict(zip(leaves, torch.autograd.grad(
        Lt, list(leaves.values()), grad_outputs=torch.from_numpy(w))))
    _close_grads(gt, gj, "spectral, per ray")

    # per film: the cotangent of each ray's radiance under sum(film.rgb) is
    # its weight in the film (the box filter's; 0 for a sample that lands
    # off the film), taken from the port's film, which equals the JAX
    # package's (test_torch_render); the same vjp with it is jax.grad of
    # the JAX package's film loss
    p_raster, _, aov = rt._radiance(rt.ds, 0, 0)
    unit = torch.ones(n, 3, requires_grad=True)
    filmmod.add_samples(rt.new_film(), rt.cfg, p_raster, unit, aov,
                        mask=rt._valid_b[0]).rgb.sum().backward()
    w_film = unit.grad.numpy()
    (gfj,) = vjp(jnp.asarray(w_film))
    vt, gft, film = rt.value_and_grad(lambda f: f.rgb.sum(),
                                      {k: getattr(rt.ds, k) for k in NAMES})
    np.testing.assert_allclose(float(vt), float((np.asarray(Lj)
                                                 * w_film).sum()), rtol=1e-5)
    np.testing.assert_allclose(float(vt), float(film.rgb.sum()), rtol=1e-6)
    _close_grads(gft, gfj, "spectral, per film", tol=GRAD_TOL)
    np.testing.assert_allclose(float((gft["light_L"] * rt.ds.light_L).sum()),
                               float(vt), rtol=1e-4)


def test_bad_sample_divergence(tmp_path):
    """The out-of-gamut scene under spectral transport has samples of
    luminance below -1e-5; both packages' films clamp them (the films
    agree), and the port's training step takes the clamped radiance. That
    the JAX package's step takes the raw radiance is held, on the same
    colours in a fog, by test_torch_volpath's
    test_train_step_divergence_on_a_fog_scene (one JAX training step for
    both divergences: its compile is most of a test's time)."""
    sj, rj, sp, rt = _pair("out_of_gamut", tmp_path)
    raw, clamped = _raw_radiance(rt, 0)
    valid = rt._valid_b[0]
    bad = valid & (luminance(raw) < -1e-5)
    assert int(bad.sum()) >= 1
    assert torch.equal(clamped[bad], torch.zeros_like(clamped[bad]))
    fj, ft = rj.render(spp=1), rt.render(spp=1)
    np.testing.assert_allclose(ft.rgb.numpy().reshape(-1, 3)[:-1],
                               np.asarray(fj.rgb).reshape(-1, 3)[:-1],
                               rtol=1e-4, atol=1e-5)
    target = np.full((8, 8, 3), 0.25, np.float32)
    step, p0 = train_step_fn(sp, None, target, device="cpu", spectral=True)
    np.testing.assert_allclose(float(step(p0, 0, 0.0)[0]),
                               step_loss(rt, clamped, target), rtol=1e-6)
    assert abs(step_loss(rt, raw, target)
               - step_loss(rt, clamped, target)) > 1e-3


def step_loss(r, L, target):
    """The training step's loss of the radiance L of batch 0 of r (one
    batch) against the image `target`."""
    valid = r._valid_b[0]
    tgt = torch.from_numpy(target).reshape(-1, 3)[
        (r._py_b[0] * r.cfg.xres + r._px_b[0]).long()]
    err = torch.where(valid[:, None], L - tgt, 0.0)
    return float((err * err).sum() / valid.sum())


def test_cli_renders_spectral(tmp_path, capsys):
    """`--spectral` renders through 60-bin transport: the image differs
    from the RGB one on saturated colours."""
    path = tmp_path / "scene.pbrt"
    path.write_text(_OUT_OF_GAMUT.replace('"xyz Kd" [0.95 0.01 0.2]',
                                          '"rgb Kd" [0.8 0.05 0.1]'))
    outs = {}
    for flags in ([], ["--spectral"]):
        out = tmp_path / f"out{len(flags)}.pfm"
        assert render_cli.main([str(path), "--cpu", "--quiet", "-o",
                                str(out)] + flags) == 0
        outs[len(flags)] = read_pfm(str(out))
    assert np.isfinite(outs[1]).all()
    assert not np.allclose(outs[0], outs[1], rtol=1e-3, atol=1e-4)

