"""Motion blur and the animated camera in the PyTorch port against the JAX
package, on the CPU: the vertex-lerp walkers per ray at random shutter
times, the motion and camera tables, the animated camera's rays, and 16x16
renders of a moving scene and of an animated camera per pixel; then the
port's own checks of `pick_traversal`, the replay on a motion scene and the
film's linearity in `light_L` under `value_and_grad`.

Tolerances, measured here: the JAX package's XLA:CPU walker contracts the
vertex lerp v + t * dv (and the triangle test's products) into fused
multiply-adds, the port does not (its CUDA kernel is built with
-fmad=false and equals its plain walker bit for bit). On 2,048 rays at
random times through randomly moving and turning triangles, `valid`,
`prim` and every counter of the live rays were equal; `t` differed by at
most 8.9e-6 relative (65 ulps at t ~ 7: the edge functions cancel), the
barycentrics by at most 2.8e-6 absolute. The walkers are held to `valid`,
`prim` and counters exact, `t` to T_RTOL and b1 / b2 to B_ATOL. The films
are held as in test_torch_render (rgb / weight within rtol 1e-4, atol 1e-5
on 99.5 % of the pixels; all 256 agreed)."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel.traverse import intersect_wide as jax_intersect_wide
from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import traverse as trav
from tpupt_torch.cameras.perspective import generate_rays
from tpupt_torch.integrators import path as tpath
from tpupt_torch.integrators import replay
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.ops import traverse_wide
from tpupt_torch.scene.device import DT_WIDTH, from_numpy, upload
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

torch.set_num_threads(1)

T_RTOL = 2e-5
B_ATOL = 1e-5
N_RAYS = 2048

# a moving emitter, a triangle that translates and turns, a floor and a
# wall that stand clear of the spatial light grid's voxel planes (a plane
# on one makes the light choice hinge on the last bit of the hit point)
MOVING = """
LookAt 0 0.5 5  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "distant" "point from" [1 3 4] "point to" [0 0 0] "rgb L" [2 2 2]
AttributeBegin
  ActiveTransform EndTime
  Translate 0.8 0 0
  ActiveTransform All
  AreaLightSource "diffuse" "rgb L" [5 5 5]
  Shape "trianglemesh" "point P" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
AttributeBegin
  ActiveTransform EndTime
  Translate 0 0.4 0.3
  Rotate 20 0 0 1
  ActiveTransform All
  Material "matte" "rgb Kd" [0.7 0.3 0.2]
  Shape "trianglemesh" "point P" [-0.5 -0.5 1  0.5 -0.5 1  0 0.6 1.2]
    "integer indices" [0 1 2]
AttributeEnd
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "point P" [-4 -1.5 -3  4 -1.5 -3  4 -1.5 3  -4 -1.5 3]
  "integer indices" [0 1 2 2 3 0]
Shape "trianglemesh" "point P" [-4 -1.5 -1.3  4 -1.5 -1.3  4 3.1 -1.3  -4 3.1 -1.3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""

_STILL = ("  ActiveTransform EndTime\n  Translate 0.8 0 0\n  ActiveTransform All\n",
          "  ActiveTransform EndTime\n  Translate 0 0.4 0.3\n  Rotate 20 0 0 1\n"
          "  ActiveTransform All\n")


def _still(txt):
    for key in _STILL:
        txt = txt.replace(key, "")
    return txt


# the same scene standing still under a camera that moves and rolls
ANIMATED = _still(MOVING).replace(
    "LookAt 0 0.5 5  0 0 0  0 1 0",
    "ActiveTransform StartTime\nLookAt -0.3 0.5 5  -0.3 0 0  0 1 0\n"
    "ActiveTransform EndTime\nLookAt 0.4 0.7 5  0.4 0 0  0.1 1 0\n"
    "ActiveTransform All")


def _both_tables(txt, **kw):
    """The JAX package's (DeviceScene, SceneStatics) of `txt` and the same
    carried across to this package."""
    ds_j, st_j = jax_upload(jax_flatten(jax_parse_string(txt)), **kw)
    return (ds_j, st_j), from_numpy(*testscenes.tables_as_numpy(ds_j, st_j),
                                    device="cpu")


def _rays(seed, dead_share=0.1):
    o, d = testscenes.aimed_rays(N_RAYS, 19, [-3, -3, -3], [3, 3, 3], 7.0)
    gen = np.random.default_rng(seed)
    time = gen.random(N_RAYS, dtype=np.float32)
    tmax = np.where(gen.random(N_RAYS) < dead_share, 0.0, np.inf).astype(
        np.float32)
    return o, d, tmax, time


@pytest.fixture(scope="module")
def moving_hits():
    """tpupt's and the port's wide walkers, closest hit, on one seeded
    scene of moving triangles and quadrics at random per-ray times (the
    JAX walker compiles its loop once a call: one call)."""
    txt = testscenes.moving_triangles_pbrt(400, 4, 4)
    (ds_j, st_j), (ds_t, st_t) = _both_tables(txt)
    o, d, tmax, time = _rays(2)
    hj, sj = jax_intersect_wide(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), time=jnp.asarray(time))
    rays = tuple(torch.from_numpy(x) for x in (o, d, tmax, time))
    ht, stt = trav.intersect_wide(ds_t, st_t, *rays[:3], time=rays[3])
    return (hj, sj), (ht, stt), (ds_t, st_t), rays


def _assert_hits_close(hj, sj, ht, stt, tmax, what):
    live = tmax > 0
    v = np.asarray(hj.valid)
    np.testing.assert_array_equal(ht.valid.numpy(), v, err_msg=what)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim),
                                  err_msg=what)
    assert v.sum() > 0.3 * live.sum(), what
    np.testing.assert_allclose(ht.t.numpy()[v], np.asarray(hj.t)[v],
                               rtol=T_RTOL, err_msg=what)
    for k in ("b1", "b2"):
        np.testing.assert_allclose(getattr(ht, k).numpy()[v],
                                   np.asarray(getattr(hj, k))[v], rtol=0,
                                   atol=B_ATOL, err_msg=what)
    for a, b in zip(sj[:3], stt[:3]):
        np.testing.assert_array_equal(b.numpy()[live], np.asarray(a)[live],
                                      err_msg=what)


def test_motion_walker_matches_jax(moving_hits):
    (hj, sj), (ht, stt), _, rays = moving_hits
    _assert_hits_close(hj, sj, ht, stt, rays[2].numpy(), "wide walker")


def test_motion_walker_equals_brute_force_and_moves(moving_hits):
    """The wide walker (shutter-union node bounds, per-prim lerp) equals
    the O(N*P) walker at the rays' times; at other times it finds other
    hits, and with no time the mid-shutter ones."""
    _, (ht, _), (ds, st), (o, d, tmax, time) = moving_hits
    hb = trav.intersect_brute(ds, st, o, d, tmax, time=time)
    for f in ("valid", "prim", "t"):
        assert torch.equal(getattr(hb, f), getattr(ht, f)), f
    # a quadric hit keeps b1 / b2 from the last triangle hit of its walk
    tri = hb.valid & (hb.prim < st.n_tris)
    for f in ("b1", "b2"):
        assert torch.equal(getattr(hb, f)[tri], getattr(ht, f)[tri]), f
    other, _ = trav.intersect_wide(ds, st, o, d, tmax, time=1.0 - time)
    assert int((other.prim != ht.prim).sum()) > 20
    mid, _ = trav.intersect_wide(ds, st, o, d, tmax)
    half, _ = trav.intersect_wide(ds, st, o, d, tmax,
                                  time=torch.full_like(time, 0.5))
    assert torch.equal(mid.t, half.t) and torch.equal(mid.prim, half.prim)


def test_motion_tables_equal_and_carry_across():
    """upload's vertex deltas (leaf order, 12 wide) and camera keys equal
    the JAX package's; from_numpy carries its tables across."""
    txt = testscenes.moving_triangles_pbrt(120, 3, 2).replace(
        'Camera "perspective"',
        "ActiveTransform EndTime\nRotate 3 0 1 0\nTranslate 0.2 0 0\n"
        'ActiveTransform All\nCamera "perspective"')
    sc_j = jax_flatten(jax_parse_string(txt))
    ds_j, st_j = jax_upload(sc_j)
    ds_t, st_t = upload(flatten(parse_string(txt)), device="cpu")
    assert st_t.has_motion and st_t.cam_animated
    assert (st_j.has_motion, st_j.cam_animated) == (True, True)
    dt = ds_t.prim_rows_dt.numpy()
    assert dt.shape == (ds_t.prim_rows.shape[0], DT_WIDTH)
    assert np.array_equal(dt[:, :9], np.asarray(ds_j.prim_rows_dt))
    assert not dt[:, 9:].any()
    for f in ("tri_dp0", "tri_dp1", "tri_dp2", "cam_q", "cam_tr",
              "prim_rows", "wide_nodes"):
        # bytes: the int metas bit-cast into the rows include NaN patterns
        assert getattr(ds_t, f).numpy().tobytes() == \
            np.asarray(getattr(ds_j, f)).tobytes(), f
    # deltas differ vertex by vertex within a turning mesh
    assert len(np.unique(dt[:, :3], axis=0)) > 10
    ds_c, st_c = from_numpy(*testscenes.tables_as_numpy(ds_j, st_j),
                            device="cpu")
    assert st_c.has_motion and st_c.cam_animated
    assert torch.equal(ds_c.prim_rows_dt, ds_t.prim_rows_dt)
    assert torch.equal(ds_c.cam_q, ds_t.cam_q)


def test_two_level_motion_scene_goes_through_the_wide_walker():
    """A motion scene with two-level tables forced still goes through K1's
    wrapper (over the single-level rows the treelets were cut from), whose
    hits match the JAX package's wide walker on the same tables."""
    txt = testscenes.moving_triangles_pbrt(600, 6, 0, seed=21)
    (ds_j, st_j), (ds_t, st_t) = _both_tables(
        txt, two_level=True, treelet_budget=(4, 128))
    assert st_t.two_level and st_t.has_motion and st_t.n_treelets >= 4
    assert tpath.pick_traversal(st_t) is traverse_wide.intersect_wide_cuda
    assert tpath.pick_traversal(st_t._replace(has_motion=False)) is not \
        traverse_wide.intersect_wide_cuda
    o, d, tmax, time = _rays(3, dead_share=0.5)
    hj, sj = jax_intersect_wide(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), time=jnp.asarray(time))
    before = traverse_wide.launches_motion
    ht, stt = traverse_wide.intersect_wide_cuda(
        ds_t, st_t, *(torch.from_numpy(x) for x in (o, d, tmax)),
        time=torch.from_numpy(time))
    assert traverse_wide.launches_motion == before  # CPU: the plain walker
    _assert_hits_close(hj, sj, ht, stt, tmax, "two-level tables")


def test_animated_camera_rays_match_jax():
    (ds_j, _), (ds_t, st_t) = _both_tables(ANIMATED)
    assert st_t.cam_animated and not st_t.has_motion
    gen = np.random.default_rng(4)
    pr = (gen.random((4096, 2)) * 16).astype(np.float32)
    ul = gen.random((4096, 2)).astype(np.float32)
    time = gen.random(4096, dtype=np.float32)
    sc = flatten(parse_string(ANIMATED))
    for lens_radius in (0.0, 0.05):
        args = (sc.camera.type, lens_radius, 3.0, 16, 16)
        oj, dj = jax_generate_rays(
            args[0], ds_j.raster_to_camera, ds_j.cam_to_world,
            jnp.asarray(pr), jnp.asarray(ul), *args[1:],
            cam_q=ds_j.cam_q, cam_tr=ds_j.cam_tr, time=jnp.asarray(time))
        ot, dt = generate_rays(
            args[0], ds_t.raster_to_camera, ds_t.cam_to_world,
            torch.from_numpy(pr), torch.from_numpy(ul), *args[1:],
            cam_q=ds_t.cam_q, cam_tr=ds_t.cam_tr,
            time=torch.from_numpy(time))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-6)
    # the two keys are the two LookAts: time 0 and 1 give their origins
    o01, _ = generate_rays(sc.camera.type, ds_t.raster_to_camera,
                           ds_t.cam_to_world, torch.full((2, 2), 8.0),
                           torch.zeros(2, 2), 0.0, 1e6, cam_q=ds_t.cam_q,
                           cam_tr=ds_t.cam_tr, time=torch.tensor([0.0, 1.0]))
    np.testing.assert_allclose(o01.numpy(), [[-0.3, 0.5, 5], [0.4, 0.7, 5]],
                               atol=1e-5)


def _film_parity(txt):
    sj = jax_flatten(jax_parse_string(txt))
    rj = JaxRenderer(sj)
    fj = rj.render(spp=2)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    rt = Renderer(flatten(parse_string(txt)), device="cpu", tables=tables)
    ft = rt.render(spp=2)
    n = 16 * 16
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    return rt, ft


def test_moving_scene_film_matches_jax():
    rt, ft = _film_parity(MOVING)
    assert rt.st.has_motion
    # the blur is there: the same scene standing still renders otherwise
    still = Renderer(flatten(parse_string(_still(MOVING))), device="cpu")
    diff = np.abs(still.image(still.render(spp=2)) - rt.image(ft))
    assert diff.max() > 0.5


def test_animated_camera_film_matches_jax():
    rt, _ = _film_parity(ANIMATED)
    assert rt.st.cam_animated and not rt.st.has_motion


def test_animated_camera_over_two_level_tables_renders():
    """An animated camera over static geometry draws a shutter time for its
    rays, but the traversal gets none: two-level tables go through the
    treelet walker, which takes no time. The render and value_and_grad run
    there, and the film equals the single-level tables' film."""
    soup = re.sub(r"ActiveTransform EndTime\n.*?ActiveTransform All\n", "",
                  testscenes.moving_triangles_pbrt(300, 3, 0, seed=21),
                  flags=re.S)
    body = soup[soup.index("WorldBegin") + 10:soup.index("WorldEnd")]
    sc = flatten(parse_string(ANIMATED.replace("WorldEnd", body + "WorldEnd")))
    tables = upload(sc, light_strategy=sc.integrator.light_strategy,
                    device="cpu", two_level=True, treelet_budget=(4, 128))
    r = Renderer(sc, device="cpu", tables=tables)
    assert r.st.two_level and r.st.n_treelets >= 2
    assert r.st.cam_animated and not r.st.has_motion
    assert r._isect is not traverse_wide.intersect_wide_cuda
    film = r.render(spp=1)
    flat = Renderer(sc, device="cpu")
    assert not flat.st.two_level
    np.testing.assert_allclose(film.rgb.numpy(),
                               flat.render(spp=1).rgb.numpy(), rtol=1e-5,
                               atol=1e-6)
    params = {"light_L": r.ds.light_L}
    value, grads, vfilm = r.value_and_grad(lambda f: f.rgb.sum(), params)
    assert torch.equal(vfilm.rgb, film.rgb)
    lin = float((params["light_L"] * grads["light_L"]).sum())
    assert lin == pytest.approx(float(value), rel=1e-5)


def test_motion_gradients_are_linear_in_light_L_and_replay_time():
    """value_and_grad on a motion scene: pass 1 records the hits at each
    ray's shutter time and pass 2 replays them (the digest covers the
    times); the film is linear in light_L, so sum(light_L * g) equals the
    loss; a replay handed other times raises."""
    sc = flatten(parse_string(MOVING))
    r = Renderer(sc, device="cpu")
    params = {k: getattr(r.ds, k) for k in ("mat_kd", "light_L")}
    value, grads, film = r.value_and_grad(lambda f: f.rgb.sum(), params)
    assert torch.isfinite(grads["mat_kd"]).all() and grads["mat_kd"].abs().sum() > 0
    lin = float((params["light_L"] * grads["light_L"]).sum())
    assert lin == pytest.approx(float(value), rel=1e-5)
    fwd = r.render(spp=1)
    np.testing.assert_allclose(film.rgb.numpy(), fwd.rgb.numpy(), rtol=1e-6,
                               atol=1e-6)
    rec = replay.HitRecorder(traverse_wide.intersect_wide_cuda)
    o, d, tmax, time = (torch.from_numpy(x) for x in _rays(5))
    rec.record(r.ds, r.st, o, d, tmax, time=time)
    rep = rec.replay()
    rep(r.ds, r.st, o, d, tmax, time=time * 0.5)
    with pytest.raises(RuntimeError, match="differ"):
        rep.finish()


def test_kd_tree_of_a_motion_scene_ignores_time():
    """A motion scene through a kd-tree goes through the kd walker, which
    tests the prims at shutter open whatever the rays' times (as in the
    JAX package)."""
    sc = dataclasses.replace(flatten(parse_string(MOVING)),
                             accelerator_name="kdtree")
    r = Renderer(sc, device="cpu")
    assert tpath.pick_traversal(r.st, alt=True) is not \
        traverse_wide.intersect_wide_cuda
    o, d, tmax, time = (torch.from_numpy(x) for x in _rays(6, 0.0))
    a, _ = r._isect(r.ds, r.st, o, d, tmax, time=time)
    b, _ = r._isect(r.ds, r.st, o, d, tmax, time=1.0 - time)
    assert torch.equal(a.t, b.t) and torch.equal(a.prim, b.prim)
    img = r.image(r.render(spp=1))
    assert np.isfinite(img).all() and img.mean() > 0


def test_static_scene_draws_no_shutter_time(monkeypatch):
    """Halton dimension 4 is the ray's shutter time and is drawn only when
    something moves: a static scene renders without it (so its other
    dimensions, and its image, are what they were before motion blur was
    ported), a motion scene and an animated camera draw it."""
    from tpupt_torch.samplers.samplers import WavefrontSampler

    dim = WavefrontSampler.dim
    drawn = []

    def spy(self, px, py, s, d):
        drawn.append(d)
        return dim(self, px, py, s, d)

    monkeypatch.setattr(WavefrontSampler, "dim", spy)
    for txt, moves in ((_still(MOVING), False), (MOVING, True),
                       (ANIMATED, True)):
        drawn.clear()
        r = Renderer(flatten(parse_string(txt)), device="cpu")
        r.render(spp=1)
        assert (4 in drawn) == moves
        assert drawn and min(drawn) == 2
