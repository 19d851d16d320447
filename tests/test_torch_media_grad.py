"""Gradients through participating media: the port's per-lane
transmittance and distance sampling (tpupt_torch/media/media.py `tr_lane`,
`sample_distance_lane`) against `jax.vjp` of the JAX package's
(tpupt/media/media.py), with respect to the lanes' origins and directions
and every float table of the media; the plain version of K6's backward
(`tr_grid_backward_plain`) against autograd of the plain forward loop; and
the autograd Functions of ops/media_tracking.py on the CPU against the
plain pair they run there.

The lanes: 2,048 seeded origins in and around a grid box, random
directions, segment ends up to 4, medium ids over a homogeneous room, two
8^3 grids and vacuum, in RGB and at 60 channels. The first grid has an
empty octant, where the density is exactly 0 and max(x, 0)'s tie decides
the derivative (1/2, jnp.maximum's rule); the second has its majorant
halved in both packages' tables, so that x = density * mean extinction /
majorant passes 1 and steps have a factor of exactly 0. Homogeneous and
vacuum lanes are the lanes K6 does not compute (dead), and some lanes' ends
come before their first step.

Tolerances: the gradients are held to 1e-4 of each table's (and of o's and
d's) largest absolute gradient, test_torch_gradients' GRAD_TOL; measured
on these lanes, at most 1.2e-6 of it (the majorant's, in RGB; the forward
loops add up logs and products whose last bits differ between XLA and ATen
now and then, test_torch_media). The plain backward against autograd of
the plain forward loop: 1e-5 of the largest (measured 3.7e-7, w2m's:
autograd sums the same terms in another order); the Functions against the
plain pair: to the bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.spectrum import rgb_to_spectrum as jax_uplift
from tpupt.integrators.volpath import media_view as jax_media_view
from tpupt.media import media as jmed
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.core import rng as trng
from tpupt_torch.core.spectrum import rgb_to_spectrum
from tpupt_torch.media import media as tmed
from tpupt_torch.ops import media_tracking as mtk

from test_torch_gradients import GRAD_TOL

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

N_LANES = 2048
RES = 8
PLAIN_TOL = 1e-5
# the float tables of a MediaTable (g enters neither function)
FLOAT_FIELDS = ("sigma_a", "sigma_s", "majorant", "density", "w2m")


def _densities():
    g = np.random.default_rng(3)
    empty = g.random((RES, RES, RES)).astype(np.float32) * 0.9 + 0.1
    empty[:RES // 2, :RES // 2, :RES // 2] = 0.0
    dense = g.random((RES, RES, RES)).astype(np.float32) * 0.5 + 0.5
    return empty, dense


def _grid_medium(name, dens, sigma_s):
    vals = " ".join(f"{v:.4f}" for v in dens.reshape(-1))
    return (f'MakeNamedMedium "{name}" "string type" "heterogeneous" '
            f'"rgb sigma_a" [0.4 0.5 0.6] "rgb sigma_s" [{sigma_s}] '
            f'"integer nx" [{RES}] "integer ny" [{RES}] "integer nz" [{RES}] '
            f'"point p0" [-1 -1 -1] "point p1" [1 1 1] "float density" '
            f'[{vals}]')


def _scene():
    empty, dense = _densities()
    return f"""
LookAt 0 0 5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "volpath" "integer maxdepth" [2]
MakeNamedMedium "room" "string type" "homogeneous" "rgb sigma_a" [0.05 0.08 0.1] "rgb sigma_s" [0.2 0.15 0.1]
MediumInterface "" "room"
WorldBegin
MediumInterface "room" "room"
{_grid_medium("empty", empty, "1.6 1.2 0.8")}
{_grid_medium("dense", dense, "2 2 2")}
AttributeBegin
MediumInterface "empty" "room"
Material "none"
Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
MediumInterface "dense" "room"
Material "none"
Translate 2 0 0
Shape "sphere" "float radius" [0.5]
AttributeEnd
Material "matte"
Shape "trianglemesh" "point P" [-9 -9 -2  9 -9 -2  9 9 -2  -9 9 -2] "integer indices" [0 1 2 0 2 3]
WorldEnd
"""


@functools.lru_cache(maxsize=None)
def _lanes():
    """(numpy media table fields, the lanes) shared by the tests; the
    dense grid's majorant halved."""
    ds, st = jax_upload(jax_flatten(jax_parse_string(_scene())))
    assert st.n_media == 3 and st.any_grid_media
    mt = {f: np.array(x) for f, x in jax_media_view(ds)._asdict().items()}
    ids = {"room": 0, "empty": 1, "dense": 2}
    assert mt["is_grid"].tolist() == [False, True, True]
    mt["majorant"][ids["dense"]] *= 0.5
    g = np.random.default_rng(17)
    n = N_LANES
    o = g.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t = g.uniform(0.0, 4.0, n).astype(np.float32)
    t[:16] = 1e-3     # ends before the first step
    t[16:32] = np.inf   # escaped: clamped at 1e7
    med = g.choice(np.array([-1, 0, 1, 1, 1, 2, 2, 2], np.int32), n)
    u1 = g.random(n).astype(np.float32)
    keys = g.integers(0, 2 ** 32, n, dtype=np.uint64)
    return mt, dict(o=o, d=d, t=t, med=med, u1=u1, keys=keys)


def _tables(channels):
    """(JAX MediaTable, port MediaTable) on the same numpy tables."""
    mt, _ = _lanes()
    mj = jmed.MediaTable(**{f: jnp.asarray(x) for f, x in mt.items()})
    mp = tmed.MediaTable(**{f: torch.from_numpy(x.copy())
                            for f, x in mt.items()})
    if channels == 60:
        mj = mj._replace(sigma_a=jax_uplift(mj.sigma_a),
                         sigma_s=jax_uplift(mj.sigma_s))
        mp = mp._replace(sigma_a=rgb_to_spectrum(mp.sigma_a),
                         sigma_s=rgb_to_spectrum(mp.sigma_s))
    return mj, mp


def _keys(lanes):
    k = lanes["keys"]
    return (jnp.asarray(k.astype(np.uint32)),
            trng.as_u32(torch.from_numpy(k.astype(np.int64))))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, what, tol=GRAD_TOL):
    for k, gr in ref.items():
        gr = np.asarray(gr)
        gp = port[k].detach().numpy()
        assert gp.shape == gr.shape, (what, k)
        assert np.isfinite(gp).all(), (what, k)
        scale = float(np.abs(gr).max())
        err = float(np.abs(gp - gr).max())
        assert err <= tol * scale, f"{what} {k}: {err} > {tol} * {scale}"


def _port_leaves(mp, lanes):
    leaves = {f: getattr(mp, f).detach().clone().requires_grad_()
              for f in FLOAT_FIELDS}
    leaves["o"] = _t(lanes["o"]).clone().requires_grad_()
    leaves["d"] = _t(lanes["d"]).clone().requires_grad_()
    return leaves


def _walk_census(mp, lanes):
    """Active steps of ratio tracking on the grid lanes where x == 0 (an
    empty texel: the tie) and where x >= 1 (a factor of 0)."""
    _, kt = _keys(lanes)
    med = _t(lanes["med"])
    mi = med.clamp_min(0).long()
    grid = mp.is_grid[mi] & (med >= 0)
    o, d = _t(lanes["o"]), _t(lanes["d"])
    t_c = _t(lanes["t"]).clamp_max(tmed.T_CLAMP)
    inv, sig = (x[mi] for x in tmed.tracking_constants(mp))
    t = torch.zeros_like(t_c)
    ties = zeros = 0
    for k in range(tmed.TR_STEPS):
        u = trng.uniform_float(kt, k, tmed.TR_WORD)
        t = t - torch.log(1.0 - u) * inv
        x = tmed.grid_density_lane(mp, mi, o + t[:, None] * d) * sig * inv
        act = grid & (t < t_c)
        ties += int((act & (x == 0.0)).sum())
        zeros += int((act & (x >= 1.0)).sum())
    return ties, zeros


@pytest.mark.parametrize("channels", [3, 60])
def test_tr_lane_gradients_match_jax(channels):
    """jax.vjp of the JAX package's tr_lane and autograd of the port's (its
    grid lanes through `TrGrid`, whose backward is tr_grid_backward_plain
    on the CPU) for one random cotangent, with respect to o, d, sigma_a,
    sigma_s, the majorant, the density atlas and the world-to-medium
    matrices; the lanes cover the tie and zero factors."""
    mt, lanes = _lanes()
    mj, mp = _tables(channels)
    kj, kt = _keys(lanes)
    ties, zeros = _walk_census(mp, lanes)
    assert ties > 100 and zeros > 100, (ties, zeros)
    med, t = lanes["med"], lanes["t"]

    def jax_tr(p):
        return jmed.tr_lane(mj._replace(**{f: p[f] for f in FLOAT_FIELDS}),
                            True, jnp.asarray(med), p["o"], p["d"],
                            jnp.asarray(t), kj)

    pj = {f: getattr(mj, f) for f in FLOAT_FIELDS}
    pj.update(o=jnp.asarray(lanes["o"]), d=jnp.asarray(lanes["d"]))
    tr_j, vjp = jax.vjp(jax_tr, pj)
    cot = np.random.default_rng(5).uniform(
        -1, 1, tr_j.shape).astype(np.float32)
    (gj,) = vjp(jnp.asarray(cot))

    leaves = _port_leaves(mp, lanes)
    mpl = mp._replace(**{f: leaves[f] for f in FLOAT_FIELDS})
    tr_t = tmed.tr_lane(mpl, True, _t(med), leaves["o"], leaves["d"],
                        _t(t), kt)
    np.testing.assert_allclose(tr_t.detach().numpy(), np.asarray(tr_j),
                               rtol=1e-4, atol=1e-5)
    gt = torch.autograd.grad(tr_t, list(leaves.values()),
                             grad_outputs=torch.from_numpy(cot))
    gt = dict(zip(leaves, gt))
    _close(gt, gj, f"tr_lane/{channels}")
    # the empty octant's texels take gradient through the tie, and every
    # float table and the lanes have some
    empty = np.zeros((RES, RES, RES), bool)
    empty[:RES // 2, :RES // 2, :RES // 2] = True
    off = int(mt["dens_off"][1])
    g_empty = gt["density"][off:off + RES ** 3].reshape(RES, RES, RES)
    assert float(g_empty[torch.from_numpy(empty)].abs().max()) > 0.0
    for k, g in gt.items():
        assert float(g.abs().max()) > 0.0, k


def test_plain_backward_matches_autograd_of_the_plain_loop():
    """tr_grid_backward_plain (explicit step formulas, prefix and suffix
    products) against autograd of tr_grid_plain for one cotangent: per lane
    o and d, per medium 1 / majorant and the mean extinction (summed over
    the lanes), the world-to-medium rows and the atlas. Dead lanes (not
    `live`) get exactly zero."""
    _, lanes = _lanes()
    _, mp = _tables(3)
    _, kt = _keys(lanes)
    med = _t(lanes["med"])
    mi = med.clamp_min(0).long()
    live = mp.is_grid[mi] & (med >= 0)
    t_c = _t(lanes["t"]).clamp_max(tmed.T_CLAMP)
    g = torch.from_numpy(np.random.default_rng(7).uniform(
        -1, 1, N_LANES).astype(np.float32))
    g_live = torch.where(live, g, 0.0)

    leaves = _port_leaves(mp, lanes)
    inv, sig = tmed.tracking_constants(mp)
    inv, sig = inv.clone().requires_grad_(), sig.clone().requires_grad_()
    mpl = mp._replace(density=leaves["density"], w2m=leaves["w2m"])

    def loop(inv_m, sig_m):
        # tr_grid_plain's loop over given constants
        iv, sg = inv_m[mi], sig_m[mi]
        trg = torch.ones_like(t_c)
        t = torch.zeros_like(t_c)
        for k in range(tmed.TR_STEPS):
            u = trng.uniform_float(kt, k, tmed.TR_WORD)
            t = t - torch.log(1.0 - u) * iv
            dens = tmed.grid_density_lane(mpl, mi, leaves["o"]
                                          + t[:, None] * leaves["d"])
            trg = trg * torch.where(t < t_c, 1.0 - torch.maximum(
                dens * sg * iv, torch.zeros(())), 1.0)
        return trg

    trg = loop(inv, sig)
    assert torch.equal(trg.detach(), tmed.tr_grid_plain(mp, mi, _t(
        lanes["o"]), _t(lanes["d"]), t_c, kt))
    ref = torch.autograd.grad(trg, [leaves["o"], leaves["d"], inv, sig,
                                    leaves["w2m"], leaves["density"]],
                              grad_outputs=g_live)
    g_lane, g_dens = tmed.tr_grid_backward_plain(
        mp, mi, _t(lanes["o"]), _t(lanes["d"]), t_c, kt, g, live)
    assert g_lane.shape == (N_LANES, tmed.TR_BWD_COLS)
    assert not g_lane[~live].any()
    m = mp.majorant.shape[0]

    def per_medium(x):
        return x.new_zeros((m,) + x.shape[1:]).index_add_(0, mi, x)
    w_rows = per_medium(g_lane[:, tmed.TR_BWD_W2M:]).reshape(m, 3, 4)
    mine = {"o": g_lane[:, 0:3], "d": g_lane[:, 3:6],
            "inv": per_medium(g_lane[:, tmed.TR_BWD_INV]),
            "sig": per_medium(g_lane[:, tmed.TR_BWD_SIG]),
            "w2m": torch.cat([w_rows, w_rows.new_zeros((m, 1, 4))], 1),
            "density": g_dens}
    _close(mine, {k: r.numpy() for k, r in zip(mine, ref)}, "plain",
           tol=PLAIN_TOL)


def test_sample_distance_lane_gradients_match_jax():
    """jax.vjp of the JAX package's sample_distance_lane against autograd
    of the port's, for random cotangents on t_m and the weight of the lanes
    whose decision agrees (a last-bit difference of a log may flip one):
    the homogeneous lanes' t_m, pdfs and weights with respect to the sigma
    tables, the grid lanes' t with respect to the majorant (the port's
    `SampleDistanceGrid`) and their weights to the sigma tables; the
    density, o and d get none in either package."""
    _, lanes = _lanes()
    mj, mp = _tables(3)
    kj, kt = _keys(lanes)
    med, t, u1 = lanes["med"], lanes["t"], lanes["u1"]

    def jax_sd(p):
        _, t_m, w = jmed.sample_distance_lane(
            mj._replace(**{f: p[f] for f in FLOAT_FIELDS}), True,
            jnp.asarray(med), p["o"], p["d"], jnp.asarray(t),
            jnp.asarray(u1), kj)
        return t_m, w

    inter_j = np.asarray(jmed.sample_distance_lane(
        mj, True, jnp.asarray(med), jnp.asarray(lanes["o"]),
        jnp.asarray(lanes["d"]), jnp.asarray(t), jnp.asarray(u1), kj)[0])
    pj = {f: getattr(mj, f) for f in FLOAT_FIELDS}
    pj.update(o=jnp.asarray(lanes["o"]), d=jnp.asarray(lanes["d"]))
    (tm_j, w_j), vjp = jax.vjp(jax_sd, pj)

    leaves = _port_leaves(mp, lanes)
    mpl = mp._replace(**{f: leaves[f] for f in FLOAT_FIELDS})
    inter_t, tm_t, w_t = tmed.sample_distance_lane(
        mpl, True, _t(med), leaves["o"], leaves["d"], _t(t), _t(u1), kt)
    same = inter_t.numpy() == inter_j
    assert same.mean() >= 0.999
    grid = mp.is_grid[_t(med).clamp_min(0).long()].numpy() & (med >= 0)
    assert inter_j[grid].mean() > 0.2 and inter_j[(med == 0)].mean() > 0.05
    # t_m of a grid lane that did not interact lies past its end: still
    # a function of the majorant, held too
    gen = np.random.default_rng(9)
    c_t = (gen.uniform(-1, 1, N_LANES) * same).astype(np.float32)
    c_w = (gen.uniform(-1, 1, (N_LANES, 3)) * same[:, None]).astype(
        np.float32)
    finite = np.isfinite(np.asarray(tm_j))
    c_t *= finite
    (gj,) = vjp((jnp.asarray(c_t), jnp.asarray(c_w)))
    gt = torch.autograd.grad([tm_t, w_t], list(leaves.values()),
                             grad_outputs=[torch.from_numpy(c_t),
                                           torch.from_numpy(c_w)],
                             allow_unused=True)
    gt = {k: g if g is not None else torch.zeros_like(leaves[k])
          for k, g in zip(leaves, gt)}
    _close(gt, gj, "sample_distance_lane")
    for k in ("sigma_a", "sigma_s", "majorant"):
        assert float(gt[k].abs().max()) > 0.0, k
    for k in ("density", "o", "d", "w2m"):
        assert not gt[k].any() and not np.asarray(gj[k]).any(), k


def test_the_functions_on_the_cpu_are_the_plain_pair():
    """On CPU tensors `TrGrid` runs tr_grid_plain forward and
    tr_grid_backward_plain backward (its per-lane outputs summed per medium
    with index_add), `SampleDistanceGrid` sample_distance_grid_plain
    forward and t / inv_max backward: to the bit, no launch counted; without
    grad the wrappers take the plain loops directly."""
    _, lanes = _lanes()
    _, mp = _tables(3)
    _, kt = _keys(lanes)
    med = _t(lanes["med"])
    mi = med.clamp_min(0).long()
    live = mp.is_grid[mi] & (med >= 0)
    o, d = _t(lanes["o"]), _t(lanes["d"])
    t_c = _t(lanes["t"]).clamp_max(tmed.T_CLAMP)
    inv, sig = tmed.tracking_constants(mp)
    leaves = [x.clone().requires_grad_()
              for x in (mp.density, mp.w2m, inv, sig, o, d)]
    before = dict(mtk.launches)
    trg = mtk.TrGrid.apply(*leaves, mp, mi, t_c, kt, live)
    assert torch.equal(trg.detach(), tmed.tr_grid_plain(mp, mi, o, d, t_c,
                                                        kt))
    g = torch.from_numpy(np.random.default_rng(11).uniform(
        -1, 1, N_LANES).astype(np.float32))
    got = torch.autograd.grad(trg, leaves, grad_outputs=g)
    g_lane, g_dens = tmed.tr_grid_backward_plain(mp, mi, o, d, t_c, kt, g,
                                                 live)
    m = inv.shape[0]

    def per_medium(x):
        return x.new_zeros((m,) + x.shape[1:]).index_add_(0, mi, x)
    want = [g_dens,
            torch.cat([per_medium(g_lane[:, 8:]).reshape(m, 3, 4),
                       g_lane.new_zeros((m, 1, 4))], 1),
            per_medium(g_lane[:, 6]), per_medium(g_lane[:, 7]),
            g_lane[:, 0:3], g_lane[:, 3:6]]
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i

    inv_leaf = inv.clone().requires_grad_()
    inter, t = mtk.SampleDistanceGrid.apply(inv_leaf, mp, mi, o, d, t_c, kt,
                                            live)
    pi, pt = tmed.sample_distance_grid_plain(mp, mi, o, d, t_c, kt)
    assert torch.equal(inter, pi) and torch.equal(t.detach(), pt)
    assert not inter.requires_grad
    (g_inv,) = torch.autograd.grad(t, inv_leaf, grad_outputs=g)
    assert torch.equal(g_inv, per_medium(g * pt / inv[mi]))
    # without grad: the plain loops themselves
    with torch.no_grad():
        assert torch.equal(mtk.tr_grid(mp, mi, o, d, t_c, kt, live),
                           tmed.tr_grid_plain(mp, mi, o, d, t_c, kt))
    assert mtk.launches == before
