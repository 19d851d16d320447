"""The bidirectional path tracer of the PyTorch port against the JAX
package's, on the CPU and on the JAX package's tables (carried across with
`from_numpy`): emission sampling and the light densities per lane for
every light type, one random walk's vertices, the sampler dimensions BDPT
draws (0-230), and BDPT films with their splats per pixel, in RGB and in
60-bin spectral transport.

Tolerances: per lane, samples and densities within rtol 1e-5 (the same
float32 expressions in the same order; sin / cos / sqrt may differ in the
last bit), on the unit-scale fields atol 1e-5 too; the random walk's
vertices lane by lane: every field within 1e-4 (`WALK_TOL`), the integer
and boolean ones equal, on at least 99.5 % of the lanes. Films: per pixel `rgb`,
`weight` and `splat` within rtol 1e-4, atol 1e-5 on at least 99.5 % of the
pixels (test_torch_direct `assert_films_agree`); measured: every pixel,
to 5.3e-6 (rgb) and 3.4e-8 (splat) at most in RGB. The sampler
dimensions are equal bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.integrators.bdpt as jbdpt
from tpupt.samplers.samplers import WavefrontSampler as JaxSampler
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt_torch.integrators import bdpt
from tpupt_torch.integrators.path import detached_traversal, pick_traversal
from tpupt_torch.samplers.samplers import WavefrontSampler
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import (LIGHT_AREA, LIGHT_DISTANT, LIGHT_GONIO,
                                       LIGHT_INFINITE, LIGHT_POINT,
                                       LIGHT_PROJECTION, LIGHT_SPOT)
from tpupt_torch.tools import testscenes
from tpupt_torch.utils import imageio

from test_torch_direct import assert_films_agree, jax_film, pair, smoke_text
from test_torch_gradients import _jax_walkers

torch.set_num_threads(1)

TOL = 1e-5
# the walk's hit points: the JAX package's XLA walker contracts a*b+c in its
# compiled loops, so a quadric's t differs from the port's plain walker by up
# to 2e-5 relative (ROADMAP.md section 3), and later vertices carry it on
# (measured: 1 of 2,048 lanes of vertex 0 off by 3.0e-5, one of vertex 2 by
# 9.8e-4); a lane agrees when all its fields are within 1e-4
WALK_TOL, LANES_AGREE = 1e-4, 0.995
N = 2048

# every light type the port has: point, spot, distant, area on a triangle
# (twosided) and on a sphere, an environment map, goniometric, projection
_LIGHTS = """
LookAt 0 0 5   0 0 0   0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [1]
Integrator "bdpt" "integer maxdepth" [2]
WorldBegin
LightSource "point" "point from" [1 2 3] "rgb I" [5 4 3]
LightSource "spot" "point from" [-1 2 3] "point to" [0 0 0]
    "float coneangle" [30] "float conedeltaangle" [8] "rgb I" [6 6 6]
LightSource "distant" "point from" [0 1 1] "point to" [0 0 0] "rgb L" [1 1 1]
LightSource "infinite" "string mapname" ["env.pfm"] "rgb L" [0.5 0.5 0.5]
AttributeBegin
  Translate 0 -1 3
  LightSource "goniometric" "rgb I" [4 4 4] "string mapname" ["gonio.pfm"]
AttributeEnd
AttributeBegin
  Translate 0.5 1 3
  LightSource "projection" "rgb I" [4 4 4] "float fov" [40]
      "string mapname" ["proj.pfm"]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [3 3 3] "bool twosided" "true"
  Translate 0 2 0
  Shape "trianglemesh" "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Translate -1.5 0.5 0
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "sphere" "float radius" [0.8]
Shape "trianglemesh" "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def _lights_scene(d):
    rng = np.random.default_rng(11)
    env = rng.uniform(0.1, 0.6, (16, 32, 3)).astype(np.float32)
    env[4, 9] = [30.0, 28.0, 25.0]  # a sun texel
    imageio.write_pfm(os.path.join(d, "env.pfm"), env)
    for name, shape in (("gonio", (8, 16, 3)), ("proj", (12, 16, 3))):
        imageio.write_pfm(os.path.join(d, f"{name}.pfm"),
                          rng.uniform(0, 1, shape).astype(np.float32))
    path = os.path.join(d, "lights.pbrt")
    with open(path, "w") as f:
        f.write(_LIGHTS)
    return path


def _tables(tmp_path):
    path = _lights_scene(str(tmp_path))
    sj = jax_flatten(jax_parse_file(path), str(tmp_path))
    dj, stj = jax_upload(sj, light_strategy="power")
    return dj, stj, from_numpy(*testscenes.tables_as_numpy(dj, stj),
                               device="cpu")


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.isfinite(a).all(), what
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=what)


def test_sample_le_and_light_densities_match_jax(tmp_path):
    """sample_le, pdf_light_dir, pdf_light_origin and
    infinite_light_density per lane, every light type on every lane
    class."""
    dj, stj, (ds, st) = _tables(tmp_path)
    types = set(np.asarray(dj.light_type).tolist())
    assert types == {LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT, LIGHT_INFINITE,
                     LIGHT_GONIO, LIGHT_PROJECTION, LIGHT_AREA}
    assert st.env_light_id >= 0 and st.env_w > 0
    rng = np.random.default_rng(5)
    lid = rng.integers(0, st.n_lights, N).astype(np.int32)
    u = rng.uniform(0, 1, (4, N)).astype(np.float32)
    out_j = jbdpt.sample_le(dj, stj, jnp.asarray(lid), *map(jnp.asarray, u))
    out_t = bdpt.sample_le(ds, st, torch.from_numpy(lid),
                           *map(torch.from_numpy, u))
    names = ("p", "n", "d", "le", "pdf_pos", "pdf_dir", "delta_o", "delta_d")
    for name, a, b in zip(names, out_j, out_t):
        _close(b.numpy(), a, f"sample_le {name}")
    # the densities toward random directions from the sampled vertices
    w = rng.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    vj = {"ns": out_j[1]}
    vt = {"ns": out_t[1]}
    _close(bdpt.pdf_light_dir(ds, st, torch.from_numpy(lid), vt,
                              torch.from_numpy(w)).numpy(),
           jbdpt.pdf_light_dir(dj, stj, jnp.asarray(lid), vj, jnp.asarray(w)),
           "pdf_light_dir")
    pmf = rng.uniform(0.1, 1, N).astype(np.float32)
    _close(bdpt.pdf_light_origin(ds, st, torch.from_numpy(lid),
                                 torch.from_numpy(pmf)).numpy(),
           jbdpt.pdf_light_origin(dj, stj, jnp.asarray(lid), jnp.asarray(pmf)),
           "pdf_light_origin")
    _close(bdpt.infinite_light_density(ds, st, torch.from_numpy(w)).numpy(),
           jbdpt.infinite_light_density(dj, stj, jnp.asarray(w)),
           "infinite_light_density")


def test_random_walk_vertices_match_jax(tmp_path):
    """One camera random walk of three steps from the lights scene's camera
    rays: every field of every vertex, and the start vertex's pdf_rev."""
    dj, stj, (ds, st) = _tables(tmp_path)
    rng = np.random.default_rng(9)
    o = np.tile(np.array([[0.0, 0.0, 5.0]], np.float32), (N, 1))
    d = rng.normal(size=(N, 3)).astype(np.float32) * [0.3, 0.3, 1]
    d[:, 2] = -np.abs(d[:, 2])
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pdf = rng.uniform(0.5, 2, N).astype(np.float32)
    u = rng.uniform(0, 1, (3, 3, N)).astype(np.float32)
    alive = rng.uniform(size=N) > 0.1
    closest, _ = _jax_walkers(stj)
    prev_j = jbdpt._make_vertex(N)
    prev_j["p"], prev_j["ns"] = jnp.asarray(o), jnp.asarray(-d)
    vj = jbdpt.random_walk(dj, stj, closest, stj.mat_features, jnp.asarray(o),
                           jnp.asarray(d), jnp.ones((N, 3)), jnp.asarray(pdf),
                           3, [jnp.asarray(x) for x in u], jnp.asarray(alive),
                           False, prev0=prev_j)
    t = torch.from_numpy
    prev_t = bdpt._make_vertex(t(o))
    prev_t["p"], prev_t["ns"] = t(o), t(-d)
    inter = detached_traversal(pick_traversal(st), ds, st, True)
    vt = bdpt.random_walk(ds, st, inter, st.mat_features, t(o), t(d),
                          torch.ones((N, 3)), t(pdf), 3, [t(x) for x in u],
                          t(alive), False, prev0=prev_t)
    assert len(vt) == len(vj) == 3
    for i, (a, b) in enumerate(zip(vj, vt)):
        assert set(a) == set(b)
        live = np.asarray(a["valid"])
        assert live.sum() > (N // 4 if i == 0 else 20)
        ok = np.ones(N, bool)
        for k in a:
            x = b[k].numpy().reshape(N, -1)
            y = np.asarray(a[k]).reshape(N, -1)
            assert np.isfinite(x).all(), (i, k)
            if x.dtype.kind in "bi":
                ok &= (x == y).all(-1)
            else:
                ok &= np.isclose(x, y, rtol=WALK_TOL, atol=WALK_TOL).all(-1)
        assert ok.mean() >= LANES_AGREE, f"vertex {i}: {(~ok).sum()} lanes"
    np.testing.assert_allclose(prev_t["pdf_rev"].numpy(), prev_j["pdf_rev"],
                               rtol=WALK_TOL, atol=WALK_TOL)


@pytest.mark.parametrize("name", ["halton", "sobol"])
def test_sampler_dims_bdpt_draws_match_jax(name):
    """Two pixels' dimensions 0-230 (BDPT draws 40+ and 200+), sample 3:
    bit for bit the JAX package's."""
    sj = JaxSampler(name, 16, 16, 4, 0)
    s = WavefrontSampler(name, 16, 16, 4, 0)
    px = np.array([5, 11], np.int32)
    py = np.array([3, 14], np.int32)
    for si in (3,):
        a = np.stack([np.asarray(sj.dim(jnp.asarray(px), jnp.asarray(py),
                                        jnp.uint32(si), k))
                      for k in range(231)])
        b = np.stack([s.dim(torch.from_numpy(px), torch.from_numpy(py), si,
                            k).numpy() for k in range(231)])
        np.testing.assert_array_equal(b, a)


# case: (scene, depth, spectral)
CASES = {
    "smoke_depth3": ("smoke", 3, False),
    "lights_depth2": ("lights", 2, False),
    "smoke_spectral": ("smoke", 2, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bdpt_film_and_splats_match_jax(case, tmp_path):
    """A BDPT sample's film, its t == 1 splats and the image (splats
    scaled by 1 / spp) per pixel; padded lanes emit no light subpath."""
    scene, depth, spectral = CASES[case]
    if scene == "lights":
        rj, rt = pair(path=_lights_scene(str(tmp_path)))
    else:
        rj, rt = pair(smoke_text("bdpt", depth=depth), spectral=spectral)
    assert rt.st.n_channels == (60 if spectral else 3)
    fj = jax_film(rj)
    ft = rt.render(spp=1)
    assert_films_agree(fj, ft, ("rgb", "weight", "splat"))
    assert float(ft.splat.sum()) > 0
    img_t, img_j = rt.image(ft), np.asarray(rj.image(fj))
    keep = np.ones(img_t.shape[:2], bool)
    keep[-1, -1] = False
    np.testing.assert_allclose(img_t[keep], img_j[keep], rtol=1e-3, atol=1e-4)


def test_padded_lanes_emit_no_light_subpath():
    """A 3x3 film pads its 1,024-lane batch with 1,015 masked lanes: the
    splats of one sample are those of its nine pixels only (the JAX
    package's `valid` rule), so the film's splat sum equals the sum over a
    render whose pad is dropped by hand."""
    from tpupt_torch.integrators.path import Renderer
    from tpupt_torch.scene.flatten import flatten
    from tpupt_torch.scene.loader import parse_string

    r = Renderer(flatten(parse_string(smoke_text("bdpt", res=3, depth=2))),
                 device="cpu")
    assert int(r._valid_b.sum()) == 9 and r.batch == 1024
    film = r.render(spp=1)
    seen = []
    orig = bdpt.bdpt_li

    def only_valid(*a, valid=None, **k):
        L, aov, sp_p, sp_L = orig(*a, valid=valid, **k)
        n = valid.shape[0]
        lane_valid = valid.repeat(sp_p.shape[0] // n)
        seen.append(float(sp_L[~lane_valid].abs().sum()))
        return L, aov, sp_p, sp_L

    bdpt.bdpt_li, saved = only_valid, bdpt.bdpt_li
    try:
        film2 = r.render(spp=1)
    finally:
        bdpt.bdpt_li = saved
    assert seen == [0.0]
    np.testing.assert_array_equal(film.splat.numpy(), film2.splat.numpy())
