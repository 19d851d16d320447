"""The port's environment, goniometric and projection lights, its
environment camera and the textured, environment-lit render against the JAX
package's, on the CPU and on the JAX package's tables (carried across with
`from_numpy`) unless a test says otherwise.

Tolerances: light samples, pdfs, radiance and camera rays within 1e-5
(relative to 1, absolute on unit directions; the same float32 expressions in
the same order, with arccos / atan2 / sin / cos last-bit differences; the
env-map lookups sit on the same texels because the sample offsets are
equal). Renders: per pixel, film `rgb` and `weight` within rtol 1e-4, atol
1e-5 on at least 99.5 % of the pixels, as tests/test_torch_render.py holds
the untextured film (a last-bit difference may flip a Russian-roulette or
lobe choice in the others); the bottom-right pixel is left out, where the
JAX film parks its masked lanes."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.lights import lights as jax_lights
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.lights import lights
from tpupt_torch.ops import traverse_kdbsp, traverse_wide
from tpupt_torch.scene.device import from_numpy, upload
from tpupt_torch.scene.flatten import (CAM_ENVIRONMENT, LIGHT_GONIO,
                                       LIGHT_PROJECTION, flatten,
                                       with_resolution)
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.tools import testscenes

from test_torch_textures import write_all_classes_scene

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

ATOL = 1e-5
N = 4096


@functools.lru_cache(maxsize=None)
def _scene_dir(tmp_root):
    d = os.path.join(tmp_root, "all_classes")
    os.makedirs(d, exist_ok=True)
    return write_all_classes_scene(d)


def _flat_both(tmp_path_factory):
    path = _scene_dir(str(tmp_path_factory.getbasetemp()))
    d = os.path.dirname(path)
    return jax_flatten(jax_parse_file(path), d), flatten(parse_file(path), d)


_TABLES = {}


def _tables(tmp_path_factory):
    """The JAX package's upload of the all-classes scene and its port
    tables (from_numpy), once per module."""
    if "t" not in _TABLES:
        sj, sp = _flat_both(tmp_path_factory)
        dj, stj = jax_upload(sj, light_strategy="spatial")
        _TABLES["t"] = (sj, sp, dj, stj, from_numpy(
            *testscenes.tables_as_numpy(dj, stj), device="cpu"))
    return _TABLES["t"]


def _u(seed, n=N):
    return np.random.default_rng(seed).uniform(0, 1, (2, n)).astype(np.float32)


def _close(a, b, what, atol=ATOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.isfinite(a).all(), what
    np.testing.assert_allclose(a, b, rtol=ATOL, atol=atol, err_msg=what)


def test_env_sampling_matches_jax(tmp_path_factory):
    """sample_env (direction, radiance, pdf), env_pdf and env_radiance on
    the same uniform samples and directions."""
    _, _, dj, stj, (ds, st) = _tables(tmp_path_factory)
    assert st.env_w == 32 and st.env_h == 16
    u1, u2 = _u(1)
    wj, lj, pj = jax_lights.sample_env(dj, stj, jnp.asarray(u1),
                                       jnp.asarray(u2))
    wt, lt, pt = lights.sample_env(ds, st, torch.from_numpy(u1),
                                   torch.from_numpy(u2))
    _close(wt, wj, "wi")
    _close(lt, lj, "Li", atol=ATOL * float(np.abs(np.asarray(lj)).max()))
    _close(pt, pj, "pdf")
    # the sun texel (1 of 512) draws its share: importance sampling is on
    lum = np.asarray(lj).sum(-1)
    assert (lum > 20).mean() > 0.02
    d = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = np.concatenate([d, np.asarray(wj)])
    _close(lights.env_pdf(ds, st, torch.from_numpy(d)),
           jax_lights.env_pdf(dj, stj, jnp.asarray(d)), "env_pdf")
    _close(lights.env_radiance(ds, st, torch.from_numpy(d)),
           jax_lights.env_radiance(dj, stj, jnp.asarray(d)), "env_radiance",
           atol=ATOL * 40)


@pytest.mark.parametrize("kind", [LIGHT_GONIO, LIGHT_PROJECTION])
def test_gonio_and_projection_samples_match_jax(kind, tmp_path_factory):
    """sample_li toward the goniometric / projection light from seeded
    points: direction, radiance scaled by the map, pdf, distance, delta."""
    _, sp, dj, stj, (ds, st) = _tables(tmp_path_factory)
    assert st.has_light_imgs
    lid = int(np.nonzero(sp.lights.type == kind)[0][0])
    rng = np.random.default_rng(5 + kind)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-1, 2.5, N)
    u1, u2 = _u(6)
    ids = np.full(N, lid, np.int32)
    sj = jax_lights.sample_li(dj, stj, jnp.asarray(ids), jnp.asarray(p),
                              jnp.asarray(u1), jnp.asarray(u2))
    s = lights.sample_li(ds, st, torch.from_numpy(ids), torch.from_numpy(p),
                         torch.from_numpy(u1), torch.from_numpy(u2))
    for f in ("wi", "li", "pdf", "dist"):
        _close(getattr(s, f), getattr(sj, f), f)
    np.testing.assert_array_equal(s.is_delta.numpy(), np.asarray(sj.is_delta))
    li = s.li.numpy()
    assert np.ptp(li) > 0.01   # the map modulates the intensity
    if kind == LIGHT_PROJECTION:
        assert 0.05 < (li.sum(-1) == 0).mean() < 0.95  # the frustum culls


def test_environment_camera_rays_match_jax(tmp_path_factory):
    sj, sp, dj, _, (ds, _) = _tables(tmp_path_factory)
    rng = np.random.default_rng(8)
    pr = (rng.uniform(0, 1, (N, 2)) * [64, 32]).astype(np.float32)
    oj, dj_ = jax_generate_rays(CAM_ENVIRONMENT, dj.raster_to_camera,
                                dj.cam_to_world, jnp.asarray(pr),
                                jnp.zeros((N, 2)), 0.0, 1e6, 64, 32)
    o, d = generate_rays(CAM_ENVIRONMENT, ds.raster_to_camera,
                         ds.cam_to_world, torch.from_numpy(pr),
                         torch.zeros(N, 2), 0.0, 1e6, 64, 32)
    _close(o, oj, "o")
    _close(d, dj_, "d")
    # every direction of the sphere: both hemispheres of the camera's y
    assert d.numpy()[:, 2].min() < -0.9 and d.numpy()[:, 2].max() > 0.9


def test_upload_builds_the_env_tables_of_the_jax_package(tmp_path_factory):
    """The port's own upload: the env map, its rotation, the light maps and
    texture tables as the JAX package's; the Distribution2D tables within
    1e-6 (numpy's float32 cumsum against XLA's); the statics."""
    sj, sp, dj, stj, _ = _tables(tmp_path_factory)
    ds, st = upload(sp, light_strategy="spatial", device="cpu")
    for k in ("env_map", "env_w2l", "light_img", "light_w2l", "light_img_off",
              "tex_atlas", "tex_mip_off", "mat_kd_tex", "mat_ks_tex"):
        np.testing.assert_array_equal(getattr(ds, k).numpy(),
                                      np.asarray(getattr(dj, k)), err_msg=k)
    for k in ("env_cond_func", "env_cond_cdf", "env_cond_integral",
              "env_marg_func", "env_marg_cdf", "env_marg_integral"):
        np.testing.assert_allclose(getattr(ds, k).numpy(),
                                   np.asarray(getattr(dj, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k in ("env_w", "env_h", "env_light_id", "has_textures",
              "has_light_imgs", "n_lights"):
        assert getattr(st, k) == getattr(stj, k), k


def _film_agrees(fj, ft, n):
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_textured_env_lit_render_matches_jax(accel, tmp_path_factory):
    """32x32, depth 3, 2 spp of the all-classes scene (every texture class,
    an env-mapped and a constant infinite light, a goniometric and a
    projection light), through the BVH and through a kd-tree: the port's
    film per pixel against the JAX package's at the same sampler."""
    sj, sp = _flat_both(tmp_path_factory)
    sj = jax_with_resolution(sj, 32, 32)
    sp = with_resolution(sp, 32, 32)
    if accel != "bvh":
        sj = dataclasses.replace(sj, accelerator_name=accel)
        sp = dataclasses.replace(sp, accelerator_name=accel)
    rj = JaxRenderer(sj)
    fj = rj.render(spp=2)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    before = (traverse_wide.launches, traverse_kdbsp.launches)
    rt = Renderer(sp, device="cpu", tables=tables)
    ft = rt.render(spp=2)
    assert (traverse_wide.launches, traverse_kdbsp.launches) == before
    assert rt.accel_stats["kind"] == accel
    assert rt.st.has_textures and rt.st.env_w > 0 and rt.st.has_light_imgs
    _film_agrees(fj, ft, 32 * 32)
    img = rt.image(ft)
    assert img.mean() > 0.01 and np.ptp(img) > 0.1
