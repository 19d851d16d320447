"""The realistic (lens-system) camera in the PyTorch port against the JAX
package, on the CPU: the lens tables, the lens trace, the exit pupil, the
camera rays and a 16x16 render per pixel.

Tolerances, measured here on the lens of `testscenes.write_lens_file`
(six rows with an aperture stop) over 8,192 film / lens samples, with and
without the exit pupil: `alive` equal on every ray, ray origins within
6e-8 and directions within 3e-7 absolute, weights equal; the exit-pupil
boxes equal. The float32 lens trace takes square roots and divisions in
another order in ATen than in XLA, so the rays are held to 1e-6 absolute,
and a lane whose `alive` differs must lie on the edge of an aperture (it
flips when the apertures grow or shrink by 1e-4). The pupil boxes are held
to one grid spacing of the candidate rays (a candidate on an aperture's
edge may pass in one and not the other), the film as in test_torch_render.
The boxes are compared at PUPIL_BINS radial bins (the JAX package builds
them with one eager trace a bin and film point: 48 s for its 64 bins); the
renders and rays of both packages take the port's 64-bin boxes, handed to
the JAX renderer in place of its own, so that they compare the camera and
the render alone."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.cameras import realistic as jax_realistic
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.cameras import realistic
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import CAM_PERSPECTIVE, CAM_REALISTIC, flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

torch.set_num_threads(1)

RAY_ATOL = 1e-6
N = 8192
PUPIL_BINS = 16


def _scene_text(lens_path, focus=5.0, aperture=8.0):
    """A floor, a wall clear of the light grid's voxel planes, a lit quad
    and a triangle seen through the lens at `focus`."""
    return f"""
LookAt 0 0.5 5  0 0 0  0 1 0
Camera "realistic" "string lensfile" ["{lens_path}"]
  "float aperturediameter" [{aperture}] "float focusdistance" [{focus}]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "distant" "point from" [1 3 4] "point to" [0 0 0] "rgb L" [2 2 2]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "matte" "rgb Kd" [0.7 0.3 0.2]
Shape "trianglemesh" "point P" [-0.5 -0.5 1  0.5 -0.5 1  0 0.6 1.2]
  "integer indices" [0 1 2]
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-4 -1.5 -3  4 -1.5 -3  4 -1.5 3  -4 -1.5 3]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-4 -1.5 -1.3  4 -1.5 -1.3  4 3.1 -1.3  -4 3.1 -1.3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


@pytest.fixture(scope="module")
def lens_path(tmp_path_factory):
    return testscenes.write_lens_file(
        str(tmp_path_factory.mktemp("lens") / "test_lens.dat"))


@pytest.fixture(scope="module")
def cameras(lens_path):
    """(JAX package's camera, this package's camera) of the test scene."""
    txt = _scene_text(lens_path)
    return (jax_flatten(jax_parse_string(txt)).camera,
            flatten(parse_string(txt)).camera)


@pytest.fixture(scope="module")
def pupil(cameras):
    """The port's exit-pupil boxes of the test lens (64 bins)."""
    cam = cameras[1]
    return realistic.bound_exit_pupil(cam.lens_data, cam.lens_z,
                                      cam.film_diag)


@pytest.fixture(scope="module")
def jax_render(lens_path, pupil):
    """The JAX package's renderer of the test scene, handed the port's
    exit-pupil boxes, and its film of 2 spp: made once for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_realistic, "bound_exit_pupil", lambda *a, **k: pupil)
        rj = JaxRenderer(jax_flatten(jax_parse_string(
            _scene_text(lens_path))))
    return rj, rj.render(spp=2)


def test_lens_tables_array_equal(lens_path, cameras):
    lens_j = jax_realistic.load_lens_file(lens_path)
    lens_t = realistic.load_lens_file(lens_path)
    assert lens_t.shape == (6, 4) and (lens_t[:, 0] == 0).sum() == 1
    assert np.array_equal(lens_t, lens_j)
    assert np.array_equal(realistic._paraxial_system_matrix(lens_t),
                          jax_realistic._paraxial_system_matrix(lens_j))
    for fd in (2.0, 5.0, 40.0):
        ft = realistic.focus_thick_lens(lens_t, fd)
        assert np.array_equal(ft, jax_realistic.focus_thick_lens(lens_j, fd))
        assert np.array_equal(realistic.element_z_positions(ft),
                              jax_realistic.element_z_positions(ft))
    cam_j, cam_t = cameras
    assert cam_t.type == CAM_REALISTIC == cam_j.type
    for f in ("lens_data", "lens_z"):
        assert np.array_equal(getattr(cam_t, f), getattr(cam_j, f)), f
    assert cam_t.film_diag == cam_j.film_diag


def test_unfocusable_distance_keeps_the_files_gap(lens_path):
    """A focus distance the rear gap cannot reach keeps the file's gap, as
    focus_thick_lens says; the JAX package's leaves the last gap it tried
    (ROADMAP.md section 3)."""
    lens = realistic.load_lens_file(lens_path)
    near = 0.01  # 1 cm in front of the front element
    got = realistic.focus_thick_lens(lens, near)
    assert np.array_equal(got, lens)
    theirs = jax_realistic.focus_thick_lens(lens, near)
    assert theirs[-1, 1] != lens[-1, 1]
    assert np.array_equal(theirs[:-1], lens[:-1])


def _samples(seed, res=16):
    gen = np.random.default_rng(seed)
    return ((gen.random((N, 2)) * res).astype(np.float32),
            gen.random((N, 2)).astype(np.float32))


def _on_aperture_edge(cam, o, d):
    """Lanes whose lens trace flips when every aperture grows or shrinks by
    1e-4."""
    out = []
    for s in (1 - 1e-4, 1 + 1e-4):
        lens = cam.lens_data.copy()
        lens[:, 3] *= s
        out.append(realistic.trace_lenses_from_film(lens, cam.lens_z, o, d)[2])
    return out[0] != out[1]


def test_lens_trace_matches_jax(cameras):
    cam_j, cam_t = cameras
    p, u = _samples(1)
    rear_z = float(cam_t.lens_z[-1])
    o = np.concatenate([(p - 8.0) * 1e-3, np.zeros((N, 1), np.float32)], -1)
    tgt = np.concatenate([(u - 0.5) * 0.02, np.full((N, 1), rear_z)], -1)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    oj, dj, aj = jax_realistic.trace_lenses_from_film(
        cam_j.lens_data, cam_j.lens_z, jnp.asarray(o), jnp.asarray(d))
    ot, dt, at = realistic.trace_lenses_from_film(
        cam_t.lens_data, cam_t.lens_z, torch.from_numpy(o),
        torch.from_numpy(d))
    aj, at = np.asarray(aj), at.numpy()
    assert 0.05 < at.mean() < 0.9
    edge = _on_aperture_edge(cam_t, torch.from_numpy(o),
                             torch.from_numpy(d)).numpy()
    assert not ((aj != at) & ~edge).any()
    both = aj & at
    np.testing.assert_allclose(ot.numpy()[both], np.asarray(oj)[both],
                               rtol=0, atol=RAY_ATOL)
    np.testing.assert_allclose(dt.numpy()[both], np.asarray(dj)[both],
                               rtol=0, atol=RAY_ATOL)


def test_exit_pupil_matches_jax(cameras, pupil):
    cam_j, cam_t = cameras
    pj = jax_realistic.bound_exit_pupil(cam_j.lens_data, cam_j.lens_z,
                                        cam_j.film_diag, n_bins=PUPIL_BINS)
    pt = realistic.bound_exit_pupil(cam_t.lens_data, cam_t.lens_z,
                                    cam_t.film_diag, n_bins=PUPIL_BINS)
    assert pt.shape == (PUPIL_BINS, 4) and pt.dtype == np.float32
    assert pupil.shape == (64, 4) and pupil.dtype == np.float32
    half = 1.5 * float(cam_t.lens_data[-1, 3])
    spacing = 2.0 * half / 63
    np.testing.assert_allclose(pt, pj, rtol=0, atol=spacing * 1.0001)
    # every box lies in the candidates' square and is no empty box
    assert (np.abs(pt) <= half + spacing * 1.0001).all()
    assert ((pt[:, 2] > pt[:, 0]) & (pt[:, 3] > pt[:, 1])).all()


@pytest.mark.parametrize("with_pupil", [False, True])
def test_realistic_rays_match_jax(cameras, pupil, with_pupil):
    cam_j, cam_t = cameras
    p, u = _samples(2)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 3.0]
    pupil = pupil if with_pupil else None
    oj, dj, aj, wj = jax_realistic.realistic_rays(
        cam_j.lens_data, cam_j.lens_z, jnp.asarray(c2w), jnp.asarray(p),
        jnp.asarray(u), 16, 16, cam_j.film_diag,
        pupil=None if pupil is None else jnp.asarray(pupil))
    ot, dt, at, wt = realistic.realistic_rays(
        cam_t.lens_data, cam_t.lens_z, torch.from_numpy(c2w),
        torch.from_numpy(p), torch.from_numpy(u), 16, 16, cam_t.film_diag,
        pupil=None if pupil is None else torch.from_numpy(pupil))
    aj, at = np.asarray(aj), at.numpy()
    assert not (aj != at).any()
    assert at.mean() > (0.5 if with_pupil else 0.1)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6)
    np.testing.assert_allclose(ot.numpy()[at], np.asarray(oj)[at], rtol=0,
                               atol=RAY_ATOL)
    np.testing.assert_allclose(dt.numpy()[at], np.asarray(dj)[at], rtol=0,
                               atol=RAY_ATOL)


def test_realistic_film_matches_jax(lens_path, jax_render):
    txt = _scene_text(lens_path)
    rj, fj = jax_render
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    rt = Renderer(flatten(parse_string(txt)), device="cpu", tables=tables)
    assert torch.equal(rt.pupil, torch.from_numpy(np.array(rj._pupil)))
    ft = rt.render(spp=2)
    n = 16 * 16
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    keep = np.ones(n, bool)
    keep[-1] = False
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    assert float(ft.rgb.sum()) > 0


def test_training_step_takes_the_films_lens_weighting(lens_path):
    """The training step's per-ray radiance is the film's: vignetted rays
    black, the rest scaled by the exit-pupil weight. Under the box filter
    of radius 0.5 one sample a pixel of the random sampler (whose jitter
    stays off the pixel's edges) lands in its own pixel alone, so the step's
    loss against a black target is the mean of the squared pixels of a
    1-spp render of the same sample."""
    from tpupt_torch.parallel.mesh import train_step_fn

    sc = flatten(parse_string(
        _scene_text(lens_path).replace('"halton"', '"random"')))
    film = Renderer(sc, device="cpu").render(spp=1)
    assert torch.equal(film.weight, torch.ones_like(film.weight))
    step, params0 = train_step_fn(sc, None, np.zeros((16, 16, 3)),
                                  device="cpu")
    loss, _ = step(params0, 0, 0.0)
    expect = float((film.rgb ** 2).sum()) / (16 * 16)
    assert float(loss) == pytest.approx(expect, rel=1e-5)


def test_missing_lens_file_falls_back_to_perspective(tmp_path):
    txt = _scene_text(str(tmp_path / "absent.dat"))
    with pytest.warns(UserWarning, match="lensfile"):
        sc = flatten(parse_string(txt))
    assert sc.camera.type == CAM_PERSPECTIVE and sc.camera.lens_data is None
    r = Renderer(dataclasses.replace(sc), device="cpu")
    assert r.pupil is None
