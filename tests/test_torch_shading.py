"""tpupt_torch shading chain against the JAX package on identical tables and
numpy inputs: camera rays, shading points, the eight material families,
every ported light type, and the film.

Tolerance rtol=2e-5, atol=1e-6 on floats: float32 transcendental functions
(log, sin, cos, acos, rsqrt) differ in the last bits between XLA and ATen,
and XLA contracts a*b+c inside its compiled helpers. Integer and boolean
outputs are exact. Two stated exceptions in `sample`: the sampled direction
is held to atol=5e-6 (it comes out of sqrt/sin/cos of the sample and a
normalisation), and f and pdf AT that direction to rtol=2e-4, because a
glossy lobe (alpha ~ 0.01) magnifies a last-bit change of the direction by
about 1/alpha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.film import film as jax_film
from tpupt.integrators.path import shading_point as jax_shading_point
from tpupt.lights import lights as jax_lights
from tpupt.materials import bsdf as jax_bsdf
from tpupt.accel.traverse import Hit as JaxHit
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel.traverse import Hit
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.film import film as tfilm
from tpupt_torch.integrators.path import shading_point
from tpupt_torch.lights import lights as tlights
from tpupt_torch.materials import bsdf as tbsdf
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import (CAM_ORTHOGRAPHIC, CAM_PERSPECTIVE,
                                       FILTER_BOX, FILTER_GAUSSIAN,
                                       FILTER_MITCHELL, FILTER_SINC,
                                       FILTER_TRIANGLE, FilmConfig)
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6
N = 512

_MATERIALS = [
    'Material "matte" "rgb Kd" [0.6 0.5 0.4]',
    'Material "matte" "rgb Kd" [0.6 0.5 0.4] "float sigma" [25]',
    'Material "plastic" "rgb Kd" [0.3 0.3 0.4] "rgb Ks" [0.4 0.4 0.4] "float roughness" [0.08]',
    'Material "mirror" "rgb Kr" [0.9 0.8 0.9]',
    'Material "glass" "float eta" [1.5]',
    'Material "metal" "float roughness" [0.05]',
    'Material "metal" "float uroughness" [0.1] "float vroughness" [0.3] "bool remaproughness" "false"',
    'Material "uber" "rgb Kd" [0.3 0.3 0.3] "rgb Ks" [0.3 0.3 0.3] "rgb Kr" [0.2 0.2 0.2] "rgb Kt" [0.2 0.2 0.2] "rgb opacity" [0.7 0.7 0.7]',
    'Material "substrate" "rgb Kd" [0.5 0.4 0.3] "rgb Ks" [0.3 0.3 0.3] "float uroughness" [0.1] "float vroughness" [0.2]',
    'Material "translucent" "rgb Kd" [0.3 0.3 0.3] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.2]',
]
_FAMILIES = ["matte", "oren_nayar", "plastic", "mirror", "glass", "metal",
             "metal_aniso", "uber", "substrate", "translucent"]


def _scene_text():
    body = ""
    for i, m in enumerate(_MATERIALS):
        x = -4.5 + i
        body += (f'AttributeBegin\n{m}\nShape "trianglemesh" "point P" '
                 f'[{x} -1 0  {x + 0.9} -1 0.2  {x + 0.4} 1 0.1] '
                 f'"integer indices" [0 1 2] "normal N" [0 0 1  0.1 0 1  0 0.1 1]\n'
                 f'AttributeEnd\n')
    return f"""
LookAt 0 0 9  0 0 0  0 1 0
Camera "perspective" "float fov" [45] "float lensradius" [0.05] "float focaldistance" [9]
Film "image" "integer xresolution" [16] "integer yresolution" [12]
WorldBegin
LightSource "point" "rgb I" [10 9 8] "point from" [0 3 3]
LightSource "spot" "rgb I" [20 20 20] "point from" [2 2 4] "point to" [0 0 0] "float coneangle" [40] "float conedeltaangle" [10]
LightSource "distant" "rgb L" [1 1 1.2] "point from" [1 2 3] "point to" [0 0 0]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "point P" [-1 2 2  1 2 2  0 3 2.5] "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 3 2] "bool twosided" "true"
  Shape "trianglemesh" "point P" [3 2 2  4 2 2  3.5 3 2] "integer indices" [0 1 2]
AttributeEnd
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [7 7 7]
  Translate -3 2 2
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Translate 0 -2 1
  Rotate 30 1 1 0
  Shape "cylinder" "float radius" [0.5] "float zmin" [-0.5] "float zmax" [0.5]
AttributeEnd
{body}
WorldEnd
"""


@pytest.fixture(scope="module")
def tables():
    sc = jax_flatten(jax_parse_string(_scene_text()))
    ds_j, st_j = jax_upload(sc, light_strategy="spatial")
    ds_t, st_t = from_numpy(*testscenes.tables_as_numpy(ds_j, st_j), device="cpu")
    return sc, (ds_j, st_j), (ds_t, st_t)


def _close(a, b, what="", rtol=RTOL, atol=ATOL):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)


def _unit(gen, n):
    v = gen.normal(0, 1, (n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("cam_type,lens", [(CAM_PERSPECTIVE, 0.0),
                                           (CAM_PERSPECTIVE, 0.05),
                                           (CAM_ORTHOGRAPHIC, 0.0),
                                           (CAM_ORTHOGRAPHIC, 0.02)],
                         ids=["persp", "persp_lens", "ortho", "ortho_lens"])
def test_generate_rays(tables, cam_type, lens):
    _, (ds_j, _), (ds_t, _) = tables
    gen = np.random.default_rng(0)
    p_raster = (gen.random((N, 2)) * [16, 12]).astype(np.float32)
    u_lens = gen.random((N, 2)).astype(np.float32)
    oj, dj = jax_generate_rays(cam_type, ds_j.raster_to_camera, ds_j.cam_to_world,
                               jnp.asarray(p_raster), jnp.asarray(u_lens), lens, 9.0)
    ot, dt = generate_rays(cam_type, ds_t.raster_to_camera, ds_t.cam_to_world,
                           torch.from_numpy(p_raster), torch.from_numpy(u_lens),
                           lens, 9.0)
    _close(oj, ot, "o")
    _close(dj, dt, "d")


def _random_hits(st, gen):
    """A hit record on every prim in turn, with valid and missed lanes."""
    n_prims = st.n_tris + st.n_spheres
    prim = (np.arange(N) % n_prims).astype(np.int32)
    valid = gen.random(N) > 0.1
    prim = np.where(valid, prim, -1).astype(np.int32)
    b1 = (gen.random(N) * 0.5).astype(np.float32)
    b2 = (gen.random(N) * 0.5).astype(np.float32)
    t = np.where(valid, gen.uniform(0.5, 9.0, N), np.inf).astype(np.float32)
    p_obj = (_unit(gen, N) * 0.5).astype(np.float32)
    return valid, t, prim, b1, b2, p_obj


def test_shading_point(tables):
    _, (ds_j, st_j), (ds_t, st_t) = tables
    gen = np.random.default_rng(1)
    valid, t, prim, b1, b2, p_obj = _random_hits(st_t, gen)
    o = gen.uniform(-3, 3, (N, 3)).astype(np.float32)
    d = _unit(gen, N)
    hj = JaxHit(*(jnp.asarray(x) for x in (valid, t, prim, b1, b2, p_obj)))
    ht = Hit(*(torch.from_numpy(x) for x in (valid, t, prim, b1, b2, p_obj)))
    sj = jax_shading_point(ds_j, st_j, hj, jnp.asarray(o), jnp.asarray(d))
    stt = shading_point(ds_t, st_t, ht, torch.from_numpy(o), torch.from_numpy(d))
    for f in sj._fields:
        _close(getattr(sj, f), getattr(stt, f), f)


@pytest.fixture(scope="module")
def bsdf_inputs(tables):
    _, (ds_j, _), (ds_t, _) = tables
    gen = np.random.default_rng(2)
    wo = _unit(gen, N)
    wo[: N // 8, 2] *= 0.02     # grazing directions
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = _unit(gen, N)
    u = gen.random((3, N)).astype(np.float32)
    uv = gen.random((N, 2)).astype(np.float32)
    return wo.astype(np.float32), wi, u, uv


@pytest.mark.parametrize("family", _FAMILIES)
def test_material_family_eval_and_sample(tables, bsdf_inputs, family):
    _, (ds_j, st_j), (ds_t, st_t) = tables
    wo, wi, u, uv = bsdf_inputs
    # material ids follow the order the scene's shapes name them in
    types = np.asarray(ds_j.mat_type)
    mid = len(types) - len(_FAMILIES) + _FAMILIES.index(family)
    mat = np.full(N, mid, np.int32)
    mj = jax_bsdf.gather_mat_params(ds_j, jnp.asarray(mat), uv=jnp.asarray(uv))
    mt = tbsdf.gather_mat_params(ds_t, torch.from_numpy(mat), uv=torch.from_numpy(uv))
    for f in ("type", "kd", "ks", "kr", "kt", "alpha_x", "alpha_y", "eta", "k",
              "sigma_a", "sigma_b", "extra", "rough", "h"):
        _close(getattr(mj, f), getattr(mt, f), f"MatParams.{f}")
    fj, pj = jax_bsdf.eval_pdf(mj, jnp.asarray(wo), jnp.asarray(wi))
    ft, pt = tbsdf.eval_pdf(mt, torch.from_numpy(wo), torch.from_numpy(wi))
    _close(fj, ft, "eval f")
    _close(pj, pt, "eval pdf")
    bj = jax_bsdf.sample(mj, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    bt = tbsdf.sample(mt, torch.from_numpy(wo), *(torch.from_numpy(x) for x in u))
    _close(bj.specular, bt.specular, "specular")
    _close(bj.wi, bt.wi, "sample wi", atol=5e-6)
    _close(bj.pdf, bt.pdf, "sample pdf", rtol=2e-4)
    _close(bj.eta_scale, bt.eta_scale, "eta_scale")
    _close(bj.f, bt.f, "sample f", rtol=2e-4)
    if family not in ("mirror", "glass"):
        assert float(bt.pdf.max()) > 0.0


def test_every_material_family_is_in_the_scene(tables):
    _, (ds_j, _), _ = tables
    assert sorted(set(np.asarray(ds_j.mat_type).tolist())) >= list(range(8))


def test_lights_sample_pdf_emit(tables):
    _, (ds_j, st_j), (ds_t, st_t) = tables
    assert st_t.n_lights == 6
    gen = np.random.default_rng(3)
    p = gen.uniform(-3, 3, (N, 3)).astype(np.float32)
    p[: N // 16] = np.asarray(ds_j.sph_o2w)[0, :3, 3] + 0.1  # inside the sphere light
    u1, u2 = gen.random((2, N)).astype(np.float32)
    lid = (np.arange(N) % st_t.n_lights).astype(np.int32)
    lj = jax_lights.sample_li(ds_j, st_j, jnp.asarray(lid), jnp.asarray(p),
                              jnp.asarray(u1), jnp.asarray(u2))
    lt = tlights.sample_li(ds_t, st_t, torch.from_numpy(lid), torch.from_numpy(p),
                           torch.from_numpy(u1), torch.from_numpy(u2))
    for f in lj._fields:
        _close(getattr(lj, f), getattr(lt, f), f"LightSample.{f}")
    kinds = set(np.asarray(ds_j.light_type).tolist())
    assert len(kinds) == 4  # point, spot, distant, area (triangle and sphere)

    n_prims = st_t.n_tris + st_t.n_spheres
    prim = (np.arange(N) % n_prims).astype(np.int32)
    wi = _unit(gen, N)
    t = gen.uniform(0.5, 9.0, N).astype(np.float32)
    _close(jax_lights.pdf_li(ds_j, st_j, jnp.asarray(p), jnp.asarray(wi),
                             jnp.asarray(prim), jnp.asarray(t)),
           tlights.pdf_li(ds_t, st_t, torch.from_numpy(p), torch.from_numpy(wi),
                          torch.from_numpy(prim), torch.from_numpy(t)), "pdf_li")
    hit_light = ((np.arange(N) % (st_t.n_lights + 1)) - 1).astype(np.int32)
    ns = _unit(gen, N)
    _close(jax_lights.emitted_radiance(ds_j, st_j, jnp.asarray(prim),
                                       jnp.asarray(hit_light), jnp.asarray(wi),
                                       jnp.asarray(ns)),
           tlights.emitted_radiance(ds_t, st_t, torch.from_numpy(prim),
                                    torch.from_numpy(hit_light),
                                    torch.from_numpy(wi), torch.from_numpy(ns)),
           "emitted_radiance")


def _cfg(ftype, radius, params=()):
    return FilmConfig(xres=16, yres=12, crop=(0, 1, 0, 1), filename="x.exr",
                      filter_type=ftype, filter_radius=radius,
                      filter_params=params, scale=1.0,
                      max_sample_luminance=np.inf, diagonal=35.0)


@pytest.mark.parametrize("ftype,radius,params", [
    (FILTER_BOX, (0.5, 0.5), ()), (FILTER_TRIANGLE, (2.0, 2.0), ()),
    (FILTER_GAUSSIAN, (2.0, 2.0), (2.0,)),
    (FILTER_MITCHELL, (2.0, 2.0), (1 / 3, 1 / 3)),
    (FILTER_SINC, (4.0, 4.0), (3.0,))],
    ids=["box", "triangle", "gaussian", "mitchell", "sinc"])
def test_add_samples(ftype, radius, params):
    """All lanes valid and inside the frame, each pixel sampled once, so the
    JAX package's single-tap path has no masked lane to misplace."""
    cfg = _cfg(ftype, radius, params)
    gen = np.random.default_rng(4)
    py, px = np.meshgrid(np.arange(12), np.arange(16), indexing="ij")
    jit = gen.uniform(0.05, 0.95, (2, 192))
    p_film = np.stack([px.ravel() + jit[0], py.ravel() + jit[1]], -1).astype(np.float32)
    L = gen.random((192, 3)).astype(np.float32)
    aov = gen.integers(0, 50, (192, 4)).astype(np.float32)
    fj = jax_film.add_samples(jax_film.new_film(16, 12), cfg, jnp.asarray(p_film),
                              jnp.asarray(L), jnp.asarray(aov))
    ft = tfilm.add_samples(tfilm.new_film(16, 12, "cpu"), cfg,
                           torch.from_numpy(p_film), torch.from_numpy(L),
                           torch.from_numpy(aov))
    for f in ("rgb", "weight", "aov"):
        np.testing.assert_allclose(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(tfilm.to_image(ft, cfg).numpy(),
                               np.asarray(jax_film.to_image(fj, cfg)),
                               rtol=1e-4, atol=1e-5)
    for k, v in jax_film.aov_images(fj, cfg).items():
        np.testing.assert_allclose(tfilm.aov_images(ft, cfg)[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-4)


def test_add_samples_drops_masked_lanes():
    """Masked and out-of-frame lanes add nothing anywhere: not to a clamped
    pixel and not to the last one."""
    cfg = _cfg(FILTER_BOX, (0.5, 0.5))
    p_film = torch.tensor([[3.5, 2.5], [100.0, 2.5], [-5.0, -5.0], [15.5, 11.5]])
    L = torch.ones((4, 3))
    aov = torch.ones((4, 4))
    mask = torch.tensor([True, True, True, False])
    film = tfilm.add_samples(tfilm.new_film(16, 12, "cpu"), cfg, p_film, L, aov,
                             mask=mask)
    assert float(film.weight.sum()) == 1.0
    assert float(film.weight[2 * 16 + 3]) == 1.0
    assert float(film.rgb[-1].sum()) == 0.0 and float(film.aov.sum()) == 4.0
