"""Reverse-mode gradients of the PyTorch port against the JAX package's
`jax.grad`, per ray through `path_li`, on the same tables (carried across
with `from_numpy`) and the same sampler; and the port's own checks of
`Renderer.value_and_grad`: central differences, finite gradients on the
dry-run scene, and the replay of pass 1's hits in pass 2. Both packages
detach traversal (the detached-sampling estimator), so the gradients flow
through the shading chain only, with respect to the parameter tables of
the JAX package's training step: the six of an untextured scene, and on a
scene of every texture class under an environment map also the texture
atlas and the environment map. The film-level gradients and the training
step are in test_torch_train.py; the textured scene's and the materials
museum's cases, and the checks that belong to them, in
test_torch_gradients_appearance.py and test_torch_gradients_materials.py,
which share this file's helpers and tolerances.

The JAX side runs its own `path_li` eagerly, with the bounce loop unrolled
(`unroll=True`, as on the TPU) and its XLA wide-BVH walker jitted once per
scene and mode: the walker's loop would otherwise compile anew at every
call, and differentiating the whole render under `jax.jit` takes minutes to
compile on the CPU.

Tolerances, measured: the forward radiance agrees per ray within rtol 1e-4,
atol 1e-5 (the film parity of test_torch_render); the per-ray gradients of
a fixed random projection of L differ from `jax.grad`'s by at most 4e-6 of
the largest absolute gradient of each table (float32 transcendentals differ
in the last bits between XLA and ATen). They are held to 1e-4 of that
largest gradient (`GRAD_TOL`). A ray whose forward radiance differs beyond
the ray tolerance (a last-bit difference that flips a Russian-roulette or
lobe choice; none on these scenes) is left out of the projection, and at
most 1 % may be."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported here, outside any trace: its module constant float(jnp.log(1.2))
# fails when the first import happens inside the JAX package's fori_loop
import tpupt.materials.bssrdf  # noqa: F401
from tpupt.accel import traverse as jax_trav
from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.materials import fourier as jax_fourier
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators import path as tpath
from tpupt_torch.integrators import replay
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.materials import bsdf as tbsdf
from tpupt_torch.parallel.mesh import PARAMS, train_step_fn
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import MAT_HAIR, flatten, with_resolution
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes

from __graft_entry__ import _SCENE_TXT
from test_differentiable import _SCENE, _SCENE2
from test_torch_textures import write_all_classes_scene

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

GRAD_TOL = 1e-4          # of the largest absolute gradient of a table
RAY_RTOL, RAY_ATOL = 1e-4, 1e-5
BENCH = ("mat_kd", "mat_ks", "mat_roughness", "light_L")
# the environment map and the texture atlas: one-row dummies, never read, in
# a scene without an environment map or textures; CORE is the rest
APPEARANCE = ("env_map", "tex_atlas")
# the small materials museum: 9 statues, so every family is in it
MATERIALS_SMALL = dict(n_hairs=8, grid=3, seg=8, rings=4)
CORE = tuple(k for k in PARAMS if k not in APPEARANCE)

# test_differentiable's scenes; the two-material one with the halton
# sampler in both packages (the port has no 02sequence sampler yet)
SCENES = {
    "matte_plane": (_SCENE, None, None),
    "two_materials": (_SCENE2.replace('"02sequence"', '"halton"'), None, None),
    # the multi-chip dry run's scene: plastic sphere under an area and a
    # distant light, whose TIR lanes once leaked NaN through sqrt(0)
    "dryrun": (_SCENE_TXT, 4, 32),
}


def _adjust(sc, depth, res):
    if depth is not None:
        sc = dataclasses.replace(sc, integrator=dataclasses.replace(
            sc.integrator, max_depth=depth))
    if res is not None:
        sc = dataclasses.replace(sc, film=dataclasses.replace(
            sc.film, xres=res, yres=res))
    return sc


def _pair(name, tmp_path=None):
    """(jax scene, jax Renderer, port scene, port Renderer) on one table set.
    "appearance": test_torch_textures' scene of every texture class under an
    environment map, a constant infinite, a goniometric and a projection
    light, at 16x16, depth 2. "materials": the small tools/testscenes.py
    materials_museum (Disney, mix, Fourier, subsurface, kdsubsurface and
    hair rows, the sobol sampler) at 32x32 (one batch; at 16x16 its few
    plastic lanes give mat_ks a gradient of 1e-15), depth 2."""
    if name == "appearance":
        path = write_all_classes_scene(str(tmp_path))
        d = os.path.dirname(path)
        # with_resolution: the whole view (the file is 1024x1024)
        sj = _adjust(jax_with_resolution(
            jax_flatten(jax_parse_file(path), d), 32, 32), 2, None)
        sp = _adjust(with_resolution(flatten(parse_file(path), d), 32, 32),
                     2, None)
    elif name == "materials":
        path = testscenes.materials_museum(str(tmp_path), **MATERIALS_SMALL)
        d = os.path.dirname(path)
        # with_resolution: the whole view (the file is 1024x1024)
        sj = _adjust(jax_with_resolution(
            jax_flatten(jax_parse_file(path), d), 32, 32), 2, None)
        sp = _adjust(with_resolution(flatten(parse_file(path), d), 32, 32),
                     2, None)
    elif name == "museum":
        path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
        d = os.path.dirname(path)
        sj, sp = (jax_flatten(jax_parse_file(path), d),
                  flatten(parse_file(path), d))
        sj, sp = _adjust(sj, None, 16), _adjust(sp, None, 16)
    else:
        txt, depth, res = SCENES[name]
        sj = _adjust(jax_flatten(jax_parse_string(txt)), depth, res)
        sp = _adjust(flatten(parse_string(txt)), depth, res)
    rj = JaxRenderer(sj)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st), device="cpu")
    return sj, rj, sp, Renderer(sp, device="cpu", tables=tables)


@functools.lru_cache(maxsize=None)
def _jitted_walkers(st):
    closest = jax.jit(lambda ds, o, d, tmax: jax_trav.intersect_wide(
        ds, st, o, d, tmax))
    occluded = jax.jit(lambda ds, o, d, tmax: jax_trav.intersect_p(
        ds, st, o, d, tmax))
    return closest, occluded


def _jax_walkers(st):
    """The JAX package's XLA walkers (its `pick_traversal` off the TPU), each
    compiled once for these statics (their Fourier sizes, a dict the
    walkers do not read, left out of the cache key)."""
    closest, occluded = _jitted_walkers(st._replace(fourier=None))
    return (lambda ds, st_, o, d, tmax, **kw: closest(ds, o, d, tmax),
            lambda ds, st_, o, d, tmax, **kw: occluded(ds, o, d, tmax))


def eager_fourier_loops(monkeypatch):
    """Run the JAX package's Fourier series loops as Python loops, the same
    operations in the same order: eagerly, `jax.lax.fori_loop` compiles its
    body at every call, and fourier_f builds a new body for each of its 16
    knot pairs (512 compiles, 93 of 137 s of one eager forward of the
    materials scene). Its loops have Python-int bounds; nothing else of
    the module's `jax` is used but `lax.cummax`."""
    import types

    def fori_loop(lo, hi, body, init):
        for i in range(lo, hi):
            init = body(i, init)
        return init

    monkeypatch.setattr(jax_fourier, "jax", types.SimpleNamespace(
        lax=types.SimpleNamespace(fori_loop=fori_loop,
                                  cummax=jax.lax.cummax)))


def _params(ds, names=CORE):
    return {k: getattr(ds, k) for k in names}


def _close_grads(g_port, g_jax, what, tol=GRAD_TOL):
    for k, gj in g_jax.items():
        gj = np.asarray(gj)
        gt = g_port[k].detach().numpy()
        assert gt.shape == gj.shape, (what, k)
        assert np.isfinite(gt).all() and np.isfinite(gj).all(), (what, k)
        scale = float(np.abs(gj).max())
        err = float(np.abs(gt - gj).max())
        assert err <= tol * scale, f"{what} {k}: {err} > {tol} * {scale}"


@pytest.mark.parametrize("name", list(SCENES))
def test_per_ray_gradients_match_jax(name, tmp_path, monkeypatch):
    """d/dtheta of sum(W * L) for a fixed random W, L the per-ray radiance
    of path_li over the renderer's camera rays of sample 0, with respect to
    the six tables of an untextured scene. The textured scene's and the
    materials museum's cases are in test_torch_gradients_appearance.py and
    test_torch_gradients_materials.py."""
    per_ray_gradients_match_jax(name, tmp_path, monkeypatch)


def per_ray_gradients_match_jax(name, tmp_path, monkeypatch):
    """The per-ray comparison of `name`'s scene (see `_pair`). On the
    "appearance" scene with respect to all eight tables: the bench's four,
    the texture atlas and the environment map, whose gathers' cotangents
    add up per texel, and the camera matrices (whose gradient reaches the
    noise textures). On the "materials" scene with respect to the bench's
    four tables; the JAX package's mat_kd gradient is NaN on the rows of
    materials other than hair, so mat_kd is compared on its other rows."""
    eager_fourier_loops(monkeypatch)
    sj, rj, sp, rt = _pair(name, tmp_path)
    names = {"appearance": PARAMS, "materials": BENCH}.get(name, CORE)
    assert rt.n_batches == 1 and rj.n_batches == 1
    n = rt.batch
    isect, isect_p = _jax_walkers(rj.st)
    integ = sj.integrator

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

    Lj, vjp = jax.vjp(jax_L, _params(rj.ds, names))
    leaves = {k: v.clone().requires_grad_()
              for k, v in _params(rt.ds, names).items()}
    _, Lt, _ = rt._radiance(rt.ds._replace(**leaves), 0, 0)
    Lt = torch.where(rt._valid_b[0][:, None], Lt, 0.0)
    Lj = np.asarray(Lj)
    agree = np.isclose(Lt.detach().numpy(), Lj, rtol=RAY_RTOL,
                       atol=RAY_ATOL).all(-1)
    assert agree.mean() >= 0.99, f"{(~agree).sum()} rays differ"
    w = np.random.default_rng(0).uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    w *= agree[:, None]
    (gj,) = vjp(jnp.asarray(w))
    gt = torch.autograd.grad(Lt, list(leaves.values()),
                             grad_outputs=torch.from_numpy(w),
                             allow_unused=True)
    gt = {k: g if g is not None else torch.zeros_like(leaves[k])
          for k, g in zip(leaves, gt)}
    if name == "materials":
        kd_j = np.asarray(gj.pop("mat_kd"))
        nan_rows = ~np.isfinite(kd_j).all(-1)
        assert nan_rows.any() and not (
            rt.ds.mat_type.numpy()[nan_rows] == MAT_HAIR).any()
        assert torch.isfinite(gt["mat_kd"]).all()
        _close_grads({"mat_kd": gt["mat_kd"][torch.from_numpy(~nan_rows)]},
                     {"mat_kd": kd_j[~nan_rows]}, name)
    _close_grads(gt, gj, name)
    if name == "appearance":
        # every material's Kd and Ks is a texture there: their rows get none
        for k in ("tex_atlas", "env_map", "light_L"):
            assert float(gt[k].abs().max()) > 1e-3, k
        assert float(gt["mat_roughness"].abs().max()) > 0.0
        return
    for k in ("mat_kd", "light_L"):
        assert float(gt[k].abs().max()) > 1e-3, k
    if name != "matte_plane":   # the plane's emitter-free, camera-flat case
        for k in names:
            assert float(gt[k].abs().max()) > 0.0, k


@pytest.mark.parametrize("field,index", [
    ("mat_kd", (0, 0)), ("mat_kd", (1, 1)), ("mat_ks", (1, 2)),
    ("mat_roughness", (1,)), ("light_L", (0, 0))])
def test_gradients_match_finite_differences(field, index):
    """test_differentiable's per-pixel case on the port alone: a delta light
    at depth 1, so no sampled direction depends on these tables and the
    detached estimator's gradient is exact; central differences of the
    port's forward render agree at that test's tolerances."""
    _, _, sp, rt = _pair("two_materials")
    w = torch.from_numpy(np.random.default_rng(1).uniform(
        0.2, 1.0, (sp.film.xres * sp.film.yres, 3)).astype(np.float32))

    def loss(film):
        return torch.sum(w * film.rgb)

    base = _params(rt.ds, BENCH)
    _, grads, _ = rt.value_and_grad(loss, base)
    g = float(grads[field][index])
    eps = 2e-3

    def probe(theta):
        p = dict(base)
        p[field] = base[field].clone()
        p[field][index] += theta
        r = Renderer(sp, device="cpu", tables=(rt.ds._replace(**p), rt.st))
        return float(loss(r.render(spp=1)))

    fd = (probe(eps) - probe(-eps)) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=3e-2, atol=5e-4)
    if field == "mat_roughness":
        assert abs(g) > 1e-6   # the sphere's glossy lobe is live


def test_matte_plane_gradients_match_finite_differences():
    """test_differentiable's first case: the mean radiance of a matte plane
    under a distant light, d/dKd and d/dL against central differences
    (rtol 2e-2), and exactly linear in L."""
    _, _, sp, rt = _pair("matte_plane")

    def value(kd, light):
        p = {"mat_kd": torch.full_like(rt.ds.mat_kd, kd),
             "light_L": torch.full_like(rt.ds.light_L, light)}
        return p, Renderer(sp, device="cpu", tables=(rt.ds._replace(**p),
                                                    rt.st))

    p, r = value(0.5, 2.0)
    v, g, _ = rt.value_and_grad(lambda f: f.rgb.mean(), p)
    eps = 1e-3
    for k, x, f in (("mat_kd", 0.5, lambda e: value(0.5 + e, 2.0)),
                    ("light_L", 2.0, lambda e: value(0.5, 2.0 + e))):
        hi, lo = (float(rr.render(spp=1).rgb.mean())
                  for rr in (f(eps)[1], f(-eps)[1]))
        np.testing.assert_allclose(float(g[k].sum()), (hi - lo) / (2 * eps),
                                   rtol=2e-2)
    assert float(g["mat_kd"].sum()) > 0.01
    np.testing.assert_allclose(float(g["light_L"].sum()) * 2.0, float(v),
                               rtol=1e-3)


def test_gradients_finite_on_the_dryrun_scene():
    """Every table's gradient is finite on the dry-run scene, the camera
    matrices' included, at its full 64x64, and nonzero."""
    sc = _adjust(flatten(parse_string(_SCENE_TXT)), None, None)
    r = Renderer(sc, device="cpu")
    v, g, _ = r.value_and_grad(lambda f: f.rgb.sum(), _params(r.ds))
    assert np.isfinite(float(v)) and float(v) > 0
    for k, x in g.items():
        assert torch.isfinite(x).all(), k
        assert float(x.abs().max()) > 1e-8, k


def test_replay_traces_the_recorded_rays_and_no_more(monkeypatch):
    """value_and_grad traverses each ray once: pass 2 replays the hits of
    pass 1 on rays equal to the recorded ones to the bit (the digest is
    swapped for the rays' bits themselves), its film is `render`'s to the
    bit, and its gradient is that of one autograd pass through a render
    with the traversal inside (four batches of 256 rays here)."""
    monkeypatch.setattr(tpath, "BATCH_RAYS", 256)
    monkeypatch.setattr(replay, "ray_digest", lambda o, d, tmax: torch.cat(
        [o.flatten(), d.flatten(), tmax]).view(torch.int32))
    sc = _adjust(flatten(parse_string(_SCENE_TXT)), 3, 32)
    r = Renderer(sc, device="cpu")
    assert r.n_batches == 4
    calls = []
    isect = r._isect

    def counted(ds, st, o, d, tmax, any_hit=False, with_stats=True):
        for x in (o, d, tmax, *ds):
            assert not (isinstance(x, torch.Tensor) and x.requires_grad)
        calls.append(any_hit)
        hit, stats = isect(ds, st, o, d, tmax, any_hit=any_hit,
                           with_stats=with_stats)
        return hit, stats

    r._isect = counted
    film = r.render(spp=1)
    n_render = len(calls)
    assert n_render == 2 * (3 + 1) * 4
    w = torch.from_numpy(np.random.default_rng(2).uniform(
        0.2, 1.0, (32 * 32, 3)).astype(np.float32))
    loss = lambda f: torch.sum(w * f.rgb)   # noqa: E731
    params = _params(r.ds)
    v, g, film_vg = r.value_and_grad(loss, params)
    assert len(calls) == 2 * n_render
    for f in ("rgb", "weight", "aov"):
        assert torch.equal(getattr(film_vg, f), getattr(film, f)), f

    # one autograd pass through the four batches, traversal inside
    leaves = {k: x.clone().requires_grad_() for k, x in params.items()}
    ds = r.ds._replace(**leaves)
    with torch.enable_grad():
        f1 = r.new_film()
        for b in range(r.n_batches):
            f1 = r._step(f1, 0, b, ds=ds)
        ref = torch.autograd.grad(loss(f1), list(leaves.values()))
    assert torch.equal(f1.rgb.detach(), film.rgb)
    for k, gr in zip(leaves, ref):
        torch.testing.assert_close(g[k], gr, rtol=1e-5, atol=1e-6 *
                                   float(gr.abs().max()), msg=k)

    # a pass 2 that traced other rays raises
    monkeypatch.setattr(tpath, "generate_rays", functools.partial(
        _nudged_rays, tpath.generate_rays))
    with pytest.raises(RuntimeError, match="differ"):
        r.value_and_grad(loss, params)


def _nudged_rays(generate_rays, *args):
    o, d = generate_rays(*args)
    if torch.is_grad_enabled():
        o = o + 1e-4
    return o, d


def test_clamped_square_roots_pass_no_nan():
    """`fr_conductor` runs on every lane, with k == 0 on the lanes of other
    materials, where its sqrt(max(x, 0)) took sqrt(0): the infinite partial
    times the zero cotangent of a masked-out lane was NaN as soon as the
    camera, and with it cos_i, was differentiated (the JAX package's
    fr_conductor still does that). `beckmann_sample_wh` did the same at
    u1 == 0. Both take `safe_sqrt` now; the forward values are unchanged."""
    cos_i = torch.tensor([0.3, 0.9], requires_grad=True)
    eta = torch.tensor([[0.5] * 3, [1.5] * 3])
    k = torch.zeros(2, 3)
    f = tbsdf.fr_conductor(cos_i, eta, k)
    keep = torch.tensor([False, True])[:, None]
    torch.where(keep, f, 0.0).sum().backward()
    assert torch.isfinite(cos_i.grad).all()
    assert torch.isfinite(f).all()

    ax = torch.tensor([0.2, 0.3], requires_grad=True)
    wo = torch.tensor([[0.0, 0.0, 1.0], [0.6, 0.0, 0.8]])
    wh = tbsdf.beckmann_sample_wh(wo, torch.zeros(2), torch.full((2,), 0.3),
                                  ax, ax.detach())
    wh.sum().backward()
    assert torch.isfinite(ax.grad).all()
    np.testing.assert_array_equal(wh[:, 2].detach().numpy(), [1.0, 1.0])


def test_value_and_grad_refuses_other_fields_and_needs_a_card():
    sc = flatten(parse_string(_SCENE))
    r = Renderer(sc, device="cpu")
    with pytest.raises(KeyError, match="not fields"):
        r.value_and_grad(lambda f: f.rgb.sum(), {"kd": r.ds.mat_kd})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Renderer(sc)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_step_fn(sc, None, np.zeros((12, 12, 3), np.float32))
    # several devices are several processes (parallel/mesh.py), never one
    with pytest.raises(ValueError, match="init_distributed"):
        train_step_fn(sc, ["cpu", "cpu"], np.zeros((12, 12, 3), np.float32),
                      device="cpu")
