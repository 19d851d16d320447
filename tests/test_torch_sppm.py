"""Stochastic progressive photon mapping of the PyTorch port against the
JAX package's, on the CPU and on the JAX package's tables: the camera
pass's visible points per pixel, one photon pass's Phi, M and voxel-cap
overflow given the JAX package's visible points, radius and grid, and a
whole render's mean.

The JAX side runs its camera and photon passes eagerly (its unjitted
methods: jitting the photon pass's 27 x 8 unrolled BSDF evaluations a
bounce takes minutes on the CPU), with its walkers jitted once per scene.
The port's deposit is another design (module docstring of
tpupt_torch/integrators/sppm.py): the same candidates, their Phi summed in
another order. Tolerances: visible points per lane, every field within
1e-4 and the integer and boolean ones equal, on at least 99.5 % of the
lanes (a last-bit difference of a walk can move a lane, as in the films);
Phi per pixel within rtol 1e-4, atol 1e-6; M and the overflow count equal;
the render's mean within 1 %."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpupt.integrators.sppm as jsppm
from tpupt_torch.integrators import sppm

from test_torch_direct import pair, smoke_text

torch.set_num_threads(1)

RES, DEPTH, PHOTONS = 16, 2, 4096
LANE_TOL, LANES_AGREE = 1e-4, 0.995


def _pair(**kw):
    rj, rt = pair(smoke_text("sppm", res=RES, depth=DEPTH, specular=True))
    sj = jsppm.SPPMRenderer(rj, photons_per_iter=PHOTONS, **kw)
    sj.npix_pad = rj.px.shape[0]
    sj._cam_jit = lambda ds, it: sj._camera_pass(ds, rj.st, it)
    sj._ph_jit = lambda ds, it, vp, radius, lo, cell: sj._photon_pass(
        ds, rj.st, it, vp, radius, lo, cell)
    st = sppm.SPPMRenderer(rt, photons_per_iter=PHOTONS, **kw)
    return sj, st


def _lanes_agree(vj, vt):
    n = vt["p"].shape[0]
    ok = np.ones(n, bool)
    for k, a in vj.items():
        x = vt[k].numpy().reshape(n, -1)
        y = np.asarray(a).reshape(n, -1)
        assert np.isfinite(x).all(), k
        if x.dtype.kind in "bi":
            ok &= (x == y).all(-1)
        else:
            ok &= np.isclose(x, y, rtol=LANE_TOL, atol=LANE_TOL).all(-1)
    assert ok.mean() >= LANES_AGREE, f"{(~ok).sum()} lanes differ"


_RENDER = {}


def _jax_render():
    """The JAX package's one-iteration render, once per module, with the
    inputs and outputs of its photon pass recorded."""
    if not _RENDER:
        sj, st = _pair()
        calls = []
        ph = sj._ph_jit

        def recording(*args):
            out = ph(*args)
            calls.append((args, out))
            return out

        sj._ph_jit = recording
        img = np.asarray(sj.render(n_iterations=1))
        sj._ph_jit = ph
        _RENDER.update(sj=sj, st=st, img=img, call=calls[0])
    return _RENDER


def test_camera_pass_visible_points_match_jax():
    """The visible point and direct light of every pixel, through the
    glass sphere and the mirror (the walk goes on through specular
    vertices)."""
    run = _jax_render()
    st = run["st"]
    (_, it, vj, _, _, _), _ = run["call"]
    vt = st.camera_pass(int(it))
    assert set(vt) == set(vj)
    _lanes_agree(vj, vt)
    have = vt["have"].numpy()[st.r._valid_b.reshape(-1).numpy()]
    assert 0.2 < have.mean() < 1.0  # misses and the light have none


@pytest.mark.parametrize("radius_scale", [1.0, 8.0])
def test_photon_pass_given_jax_inputs_matches_jax(radius_scale):
    """Phi per pixel, M and the overflow of one photon pass over the JAX
    package's visible points, radius and grid: the JAX render's own pass
    (the initial radius), and one at 8x its radius, where voxels hold more
    than VOXEL_CAP points and overflow."""
    run = _jax_render()
    sj, st = run["sj"], run["st"]
    (ds, it, vj, radius, grid_lo, cell), out = run["call"]
    if radius_scale != 1.0:
        radius = radius * radius_scale
        cell = jnp.max(radius) * 1.0001
        grid_lo = ds.world_lo - 2 * cell
        out = sj._ph_jit(ds, it, vj, radius, grid_lo, cell)
    phi_j, m_j, ovf_j = out
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    vt = {k: t(v) for k, v in vj.items()}
    phi_t, m_t, ovf_t = st.photon_pass(int(it), vt, t(radius), t(grid_lo),
                                       t(cell))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert ovf_t == int(ovf_j)
    assert (ovf_t > 0) == (radius_scale > 1)
    assert float(m_t.sum()) > 20
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-4,
                               atol=1e-6)


def test_render_mean_matches_jax():
    """One iteration: the image's mean, the film it leaves (rgb with unit
    weights) and the overflow count."""
    run = _jax_render()
    img_j, st = run["img"], run["st"]
    img_t = st.render(n_iterations=1)
    assert img_t.shape == (RES, RES, 3) and np.isfinite(img_t).all()
    np.testing.assert_allclose(img_t.mean(), img_j.mean(), rtol=1e-2)
    keep = np.ones((RES, RES), bool)
    keep[-1, -1] = False
    assert np.isclose(img_t, img_j, rtol=1e-3, atol=1e-4).all(-1)[keep] \
        .mean() >= 0.95
    assert st.overflow == 0
    assert (st.film.weight.numpy() == 1).all()
    np.testing.assert_allclose(st.film.rgb.numpy().reshape(img_t.shape),
                               img_t, rtol=1e-6)
