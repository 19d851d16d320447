"""Participating media of the PyTorch port against the JAX package's
(tpupt_torch/media/media.py against tpupt/media/media.py): the media tables
and each prim's MediumInterface that `upload` builds, the Henyey-Greenstein
phase function, the grid density lookup, and the per-lane transmittance
and distance sampling (ratio and delta tracking on grid lanes: on the CPU
the plain versions of kernel K6) on 4,096 seeded lanes, in RGB and at 60
channels.

Tolerances, measured. The grid lookup's world-to-medium product is an
einsum in the JAX package and term-by-term products here: the densities
came out equal to the bit on these lanes (held to rtol 1e-5, atol 1e-6,
as XLA may contract the einsum's products elsewhere). The tracking loops
add up -log(1 - u) / majorant over up to 64 steps, and XLA's log and
ATen's differ in the last bit now and then: the transmittance within
7.2e-7 (4.3 % of its values not to the bit), t within 2.3e-7 relative and
the weights within 9.6e-7 (held to rtol 1e-4, atol 1e-5); every lane took
the same decisions (held: interacted equal on at least 99.9 % of the
lanes)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tpupt.core import rng as jrng
from tpupt.core.spectrum import rgb_to_spectrum as jax_uplift
from tpupt.integrators.volpath import _hg_sample_lane as jax_hg_sample_lane
from tpupt.integrators.volpath import media_view as jax_media_view
from tpupt.media import media as jmed
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.core import rng as trng
from tpupt_torch.core.spectrum import rgb_to_spectrum
from tpupt_torch.integrators.volpath import _hg_sample_lane
from tpupt_torch.media import media as tmed
from tpupt_torch.scene.device import upload
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

N_LANES = 4096
RTOL, ATOL = 1e-4, 1e-5
SAME_DECISIONS = 0.999


def _density(n=6, seed=2):
    return " ".join(f"{v:.4f}" for v in
                    np.random.default_rng(seed).random(n ** 3))


_HEAD = """
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "volpath" "integer maxdepth" [2]
WorldBegin
"""
_ROOM = ('MakeNamedMedium "room" "string type" "homogeneous" '
         '"rgb sigma_a" [0.02 0.03 0.05] "rgb sigma_s" [0.1 0.08 0.06] '
         '"float g" [0.2]')
_PLUME = ('MakeNamedMedium "plume" "string type" "heterogeneous" '
          '"rgb sigma_a" [0.3 0.3 0.3] "rgb sigma_s" [1.5 1.2 0.9] '
          '"float g" [0.5] "integer nx" [6] "integer ny" [6] "integer nz" [6] '
          '"point p0" [-1 -1 -1] "point p1" [1 1 1] "float density" [%s]'
          % _density())
_TINT = ('MakeNamedMedium "tint" "string type" "homogeneous" '
         '"rgb sigma_a" [0.6 0.2 0.05] "rgb sigma_s" [0.05 0.05 0.05]')
_BOX = """AttributeBegin
Material "none"
MediumInterface "plume" "room"
Shape "trianglemesh" "point P" [-1 -1 -1  1 -1 -1  1 1 -1  -1 1 -1  -1 -1 1  1 -1 1  1 1 1  -1 1 1]
 "integer indices" [0 2 1 0 3 2  4 5 6 4 6 7  0 1 5 0 5 4  1 2 6 1 6 5  2 3 7 2 7 6  3 0 4 3 4 7]
AttributeEnd"""
_SPHERE = """AttributeBegin
MediumInterface "tint" "room"
Material "glass"
Translate 2 0 0
Shape "sphere" "float radius" [0.5]
AttributeEnd"""
_FLOOR = ('Material "matte"\nShape "trianglemesh" "point P" '
          '[-9 -9 -2  9 -9 -2  9 9 -2  -9 9 -2] "integer indices" [0 1 2 0 2 3]')

SCENES = {
    # one homogeneous medium, no interface: the camera medium
    "homogeneous": _HEAD + _ROOM + "\n" + _FLOOR + "\nWorldEnd\n",
    # a grid medium only: the camera medium
    "grid": _HEAD + _PLUME + "\n" + _FLOOR + "\nWorldEnd\n",
    # all three, the room around a null box of plume and a tinted sphere
    "interfaces": (_HEAD.replace("WorldBegin", _ROOM + '\nMediumInterface "" '
                                 '"room"\nWorldBegin').replace(
        "LookAt", 'MediumInterface "" "room"\nLookAt')
        + 'MediumInterface "room" "room"\n' + _PLUME + "\n" + _TINT + "\n"
        + _BOX + "\n" + _SPHERE + "\n" + _FLOOR + "\nWorldEnd\n"),
}
MED_FIELDS = ("med_sigma_a", "med_sigma_s", "med_g", "med_majorant",
              "med_is_grid", "med_density", "med_dens_off", "med_dens_dims",
              "med_w2m", "prim_med_in", "prim_med_out")


def _uploads(name):
    txt = SCENES[name]
    return (jax_upload(jax_flatten(jax_parse_string(txt))),
            upload(flatten(parse_string(txt)), device="cpu"))


@pytest.mark.parametrize("name", list(SCENES))
def test_media_tables_array_equal(name):
    (ds_j, st_j), (ds_t, st_t) = _uploads(name)
    for f in MED_FIELDS:
        a, b = np.asarray(getattr(ds_j, f)), getattr(ds_t, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("n_media", "camera_medium", "any_grid_media",
              "has_med_interfaces"):
        assert getattr(st_j, f) == getattr(st_t, f), f
    want = {"homogeneous": (1, 0, False, False), "grid": (1, 0, True, False),
            "interfaces": (3, 0, True, True)}[name]
    assert (st_t.n_media, st_t.camera_medium, st_t.any_grid_media,
            st_t.has_med_interfaces) == want


@pytest.fixture(scope="module")
def lanes():
    """The interface scene's media table in both packages and 4,096 seeded
    lanes: origins in and around the plume's box, random directions,
    segment ends up to 6, medium ids over the three media and vacuum, and
    uniform hash keys."""
    (ds_j, st_j), (ds_t, _) = _uploads("interfaces")
    g = np.random.default_rng(17)
    n = N_LANES
    o = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = g.exponential(2.0, n).astype(np.float32)
    t[:64] = np.inf   # escaped rays: clamped at 1e7
    med = g.integers(-1, 3, n).astype(np.int32)
    med[n // 4:n // 2] = 1
    u1 = g.random(n).astype(np.float32)
    keys = g.integers(0, 2 ** 32, n, dtype=np.uint64)
    return dict(mt_j=jax_media_view(ds_j), mt_t=tmed.media_view(ds_t),
                o=o, d=d, t=t, med=med, u1=u1, keys=keys)


def _tables(lanes, channels):
    mt_j, mt_t = lanes["mt_j"], lanes["mt_t"]
    if channels == 60:
        mt_j = mt_j._replace(sigma_a=jax_uplift(mt_j.sigma_a),
                             sigma_s=jax_uplift(mt_j.sigma_s))
        mt_t = mt_t._replace(sigma_a=rgb_to_spectrum(mt_t.sigma_a),
                             sigma_s=rgb_to_spectrum(mt_t.sigma_s))
    return mt_j, mt_t


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_grid_density_lookup(lanes):
    mt_j, mt_t = lanes["mt_j"], lanes["mt_t"]
    mi = np.ones(N_LANES, np.int32)
    p = lanes["o"] * 0.8
    a = np.asarray(jmed._grid_density_lane(mt_j, jnp.asarray(mi),
                                           jnp.asarray(p)))
    b = tmed.grid_density_lane(mt_t, _t(mi).long(), _t(p)).numpy()
    assert (a > 0).mean() > 0.9
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    # outside the grid: no density
    far = tmed.grid_density_lane(mt_t, _t(mi).long(), _t(p) + 5.0)
    assert not far.any()


def test_hg_phase_and_sampling(lanes):
    g = np.random.default_rng(23)
    n = N_LANES
    cos = g.uniform(-1, 1, n).astype(np.float32)
    gv = g.choice(np.array([-0.7, -0.3, 0.0, 0.0005, 0.3, 0.8], np.float32),
                  n)
    np.testing.assert_allclose(
        tmed.hg_phase(_t(cos), _t(gv)).numpy(),
        np.asarray(jmed.hg_phase(jnp.asarray(cos), jnp.asarray(gv))),
        rtol=1e-5, atol=1e-7)
    u1, u2 = g.random((2, n)).astype(np.float32)
    axis = lanes["d"]
    wi_j, pdf_j = jax_hg_sample_lane(jnp.asarray(axis), jnp.asarray(u1),
                                     jnp.asarray(u2), jnp.asarray(gv))
    wi_t, pdf_t = _hg_sample_lane(_t(axis), _t(u1), _t(u2), _t(gv))
    np.testing.assert_allclose(wi_t.numpy(), np.asarray(wi_j), atol=2e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-4,
                               atol=1e-6)
    for gs in (0.0, 0.6):   # one medium's g
        wj, pj = jmed.hg_sample(jnp.asarray(axis), jnp.asarray(u1),
                                jnp.asarray(u2), gs)
        wt, pt = tmed.hg_sample(_t(axis), _t(u1), _t(u2), gs)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=2e-5)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4)


def _keys(lanes):
    k = lanes["keys"]
    return (jnp.asarray(k.astype(np.uint32)),
            trng.as_u32(torch.from_numpy(k.astype(np.int64))))


@pytest.mark.parametrize("channels", [3, 60])
def test_tr_lane_matches(lanes, channels):
    mt_j, mt_t = _tables(lanes, channels)
    kj, kt = _keys(lanes)
    a = np.asarray(jmed.tr_lane(mt_j, True, jnp.asarray(lanes["med"]),
                                jnp.asarray(lanes["o"]),
                                jnp.asarray(lanes["d"]),
                                jnp.asarray(lanes["t"]), kj))
    b = tmed.tr_lane(mt_t, True, _t(lanes["med"]), _t(lanes["o"]),
                     _t(lanes["d"]), _t(lanes["t"]), kt).numpy()
    assert b.shape == (N_LANES, channels)
    grid = lanes["med"] == 1
    assert (a[grid] < 1.0).mean() > 0.3 and (b[lanes["med"] < 0] == 1).all()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("channels", [3, 60])
def test_sample_distance_lane_matches(lanes, channels):
    mt_j, mt_t = _tables(lanes, channels)
    kj, kt = _keys(lanes)
    ij, tj, wj = (np.asarray(x) for x in jmed.sample_distance_lane(
        mt_j, True, jnp.asarray(lanes["med"]), jnp.asarray(lanes["o"]),
        jnp.asarray(lanes["d"]), jnp.asarray(lanes["t"]),
        jnp.asarray(lanes["u1"]), kj))
    it, tt, wt = (x.numpy() for x in tmed.sample_distance_lane(
        mt_t, True, _t(lanes["med"]), _t(lanes["o"]), _t(lanes["d"]),
        _t(lanes["t"]), _t(lanes["u1"]), kt))
    assert wt.shape == (N_LANES, channels)
    grid, vac = lanes["med"] == 1, lanes["med"] < 0
    assert ij[grid].mean() > 0.1 and ij[~grid & ~vac].mean() > 0.1
    assert not it[vac].any()
    same = it == ij
    assert same.mean() >= SAME_DECISIONS, f"{(~same).sum()} lanes differ"
    # medium 0 is homogeneous, so the vacuum lanes' unused t_m agrees too
    np.testing.assert_allclose(tt[same], tj[same], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt[same], wj[same], rtol=RTOL, atol=ATOL)


def test_the_wrappers_take_the_plain_loops_on_the_cpu(lanes):
    """On CPU tensors K6's wrappers are its plain loops: the same lanes,
    no launch counted."""
    from tpupt_torch.ops import media_tracking

    mt = lanes["mt_t"]
    _, kt = _keys(lanes)
    med = _t(lanes["med"])
    mi = med.clamp_min(0).long()
    live = mt.is_grid[mi] & (med >= 0)
    args = (mt, mi, _t(lanes["o"]), _t(lanes["d"]),
            _t(lanes["t"]).clamp_max(tmed.T_CLAMP), kt)
    before = dict(media_tracking.launches)
    assert torch.equal(media_tracking.tr_grid(*args, live),
                       tmed.tr_grid_plain(*args))
    assert all(torch.equal(x, y) for x, y in zip(
        media_tracking.sample_distance_grid(*args, live),
        tmed.sample_distance_grid_plain(*args)))
    assert media_tracking.launches == before


@pytest.mark.parametrize("name", ["homogeneous", "grid"])
def test_one_medium_functions_match(name, lanes):
    """The one-medium functions tools read through `Renderer._medium`
    (build_medium, transmittance, sample_distance) against the JAX
    package's on the lanes' rays, the medium of each scene."""
    from tpupt.integrators.path import Renderer as JaxRenderer
    from tpupt_torch.integrators.path import Renderer

    txt = SCENES[name]
    mj = JaxRenderer(jax_flatten(jax_parse_string(txt)))._medium
    mt = Renderer(flatten(parse_string(txt)), device="cpu")._medium
    assert mt.kind == mj.kind == (tmed.MEDIUM_GRID if name == "grid"
                                  else tmed.MEDIUM_HOMOGENEOUS)
    assert np.array_equal(mt.density, np.asarray(mj.density))
    assert np.array_equal(mt.w2m, np.asarray(mj.w2m))
    assert mt.sigma_t_max == mj.sigma_t_max
    kj, kt = _keys(lanes)
    o, d, t, u1 = (lanes[k] for k in ("o", "d", "t", "u1"))
    a = np.asarray(jmed.transmittance(mj, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t), kj))
    b = tmed.transmittance(mt, _t(o), _t(d), _t(t), kt).numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    ij, tj, wj = (np.asarray(x) for x in jmed.sample_distance(
        mj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        jnp.asarray(u1), kj))
    it, tt, wt = (x.numpy() for x in tmed.sample_distance(
        mt, _t(o), _t(d), _t(t), _t(u1), kt))
    assert (it == ij).mean() >= SAME_DECISIONS and ij.any()
    np.testing.assert_allclose(tt[it == ij], tj[it == ij], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(wt[it == ij], wj[it == ij], rtol=RTOL,
                               atol=ATOL)
    if name == "grid":
        p = o * 0.8
        np.testing.assert_allclose(
            tmed.grid_density(mt, _t(p)).numpy(),
            np.asarray(jmed.grid_density(mj, jnp.asarray(p))),
            rtol=1e-5, atol=1e-6)
