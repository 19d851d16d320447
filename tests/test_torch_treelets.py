"""tpupt_torch two-level traversal (the module that holds CUDA kernel
`traverse_treelets`) against the JAX package: the same treelets, and the same
hits on identical rays.

Small treelet capacities cut small scenes into many treelets, as in
tests/test_treelets.py. On the CPU `intersect_treelets_cuda` runs the
kernel's plain version, `accel.traverse.intersect_two_level`. Tolerances:

- treelet tables: every bound, meta and prim row equal to the JAX package's
  after decoding its padded, float-coded blocks.
- against the JAX package's `intersect_wide` on the same wide tree (what its
  renderer runs off the TPU): `valid`, `prim` exact, triangle `t` <= 4 ulp,
  barycentrics 1e-5 absolute, quadric `t` 2e-5 relative (XLA's CPU compiler
  contracts a*b+c, PyTorch does not; see test_torch_traverse.py). The
  barycentric error grows with distance over triangle size, and these rays
  start 21 to 26 units from triangles 0.3 wide: measured worst 7.03e-6
  (clusters), against 4.04e-6 on that file's scenes.
- against this package's own single-level walker on the same wide tree:
  `t`, `b1`, `b2`, `prim` equal to the bit (the same arithmetic in the same
  order). Leaf visits and prim tests are never more (a one-leaf treelet
  tests its box again, with the ray's current t, before the leaf), and node
  visits differ by exactly the visits of such one-leaf treelet roots.
- against the TPU kernel in interpret mode: `valid`, `prim` exact except on
  zero-edge rays, `t` 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel.traverse import intersect_wide as jax_intersect_wide
from tpupt.ops.traverse_stream import intersect_packets_streamed
from tpupt.scene.device import nodes_to_tiles
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import traverse as trav
from tpupt_torch.accel.treelets import build_treelets
from tpupt_torch.integrators.path import Renderer, pick_traversal
from tpupt_torch.ops import traverse_treelets, traverse_wide
from tpupt_torch.ops.traverse_treelets import intersect_treelets_cuda
from tpupt_torch.scene.device import (TWO_LEVEL_FIELDS, from_numpy, upload)
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes

N_RAYS = 2048
BARY_TOL = 1e-5
QUADRIC_T_RTOL = 2e-5
BUDGETS = {"clusters": (32, 256), "clusters_spheres": (16, 128),
           "museum": (8, 256)}


def _parsed(name, tmp):
    if name == "museum":
        path = genscene.museum(str(tmp), grid=2, seg=8, rings=4)
        return (jax_flatten(jax_parse_file(path), str(tmp)),
                flatten(parse_file(path), str(tmp)))
    txt = testscenes.triangle_clusters_pbrt(
        600, 12, 6 if name == "clusters_spheres" else 0, lights=True)
    return jax_flatten(jax_parse_string(txt)), flatten(parse_string(txt))


@pytest.fixture(scope="module", params=list(BUDGETS))
def scene(request, tmp_path_factory):
    name = request.param
    sj, st_ = _parsed(name, tmp_path_factory.mktemp(name))
    jx = jax_upload(sj, two_level=True, treelet_budget=BUDGETS[name])
    own = upload(st_, device="cpu", two_level=True,
                 treelet_budget=BUDGETS[name])
    carried = from_numpy(*testscenes.tables_as_numpy(*jx), device="cpu")
    lo, hi = np.asarray(jx[0].world_lo), np.asarray(jx[0].world_hi)
    o, d = testscenes.aimed_rays(N_RAYS, 19, lo, hi)
    return name, jx, own, carried, o, d


def _metas(rows):
    return np.ascontiguousarray(rows[:, 48:56]).view(np.int32)


def test_treelet_tables_match_jax(scene):
    name, (ds_j, st_j), (ds_t, st_t), (ds_c, st_c), _, _ = scene
    for f in ("two_level", "n_treelets", "tl_tn", "tl_tp", "max_leaf",
              "n_wide_nodes"):
        assert getattr(st_j, f) == getattr(st_t, f) == getattr(st_c, f), f
    assert st_t.two_level and st_t.n_treelets >= 4
    # the carried tables and the package's own upload are the same tables
    for f in ("wide_nodes", "prim_rows") + TWO_LEVEL_FIELDS:
        a, b = getattr(ds_t, f).numpy(), getattr(ds_c, f).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert ds_t.wide_nodes.numpy().tobytes() == \
        np.asarray(ds_j.wide_nodes).tobytes()

    # top tree: same bounds; interior ids and treelet ids as float-coded
    top_j = np.asarray(ds_j.top_tiles)
    top_t = ds_t.top_nodes.numpy()
    assert len(top_j) == len(top_t)
    np.testing.assert_array_equal(top_t[:, :48].reshape(-1, 8, 6),
                                  top_j[:, :, :6])
    m = _metas(top_t)
    empty = m == -2**31
    ref = (m < 0) & ~empty
    np.testing.assert_array_equal(top_j[:, :, 6][m >= 0], m[m >= 0])
    np.testing.assert_array_equal(top_j[:, :, 6][empty], 0.0)
    np.testing.assert_array_equal(top_j[:, :, 6][ref], -1.0)
    np.testing.assert_array_equal(top_j[:, :, 7][ref], -m[ref] - 1)

    # treelets: the JAX package's padded blocks, decoded, hold these rows
    tn, tp = st_j.tl_tn, st_j.tl_tp
    nodes_j = np.asarray(ds_j.tl_nodes)[:, :64].reshape(-1, tn, 8, 8)
    prims_j = np.asarray(ds_j.tl_prims).reshape(-1, tp, 32)
    off = ds_t.tl_offsets.numpy()
    nodes_t, prims_t = ds_t.tl_nodes.numpy(), ds_t.tl_prims.numpy()
    ends = np.append(off[1:, 0], len(nodes_t))
    for tid in range(st_t.n_treelets):
        rows = nodes_t[off[tid, 0]: ends[tid]]
        tiles = nodes_to_tiles(rows)
        np.testing.assert_array_equal(tiles[:, :, :7],
                                      nodes_j[tid, :len(rows), :, :7])
        assert not nodes_j[tid, len(rows):].any()
        mt = _metas(rows)
        for r, c in zip(*np.nonzero((mt < 0) & (mt != -2**31))):
            v = -mt[r, c] - 1
            first_t, count = off[tid, 1] + (v >> 6), v & 63
            first_j = int(nodes_j[tid, r, c, 7])
            np.testing.assert_array_equal(
                prims_t[first_t: first_t + count],
                prims_j[tid, first_j: first_j + count])


def test_partition_covers_every_prim_once(scene):
    _, _, (ds, st), _, _, _ = scene
    gids = np.sort(ds.tl_prims.numpy().view(np.int32)[:, 16])
    np.testing.assert_array_equal(gids, np.arange(st.n_tris + st.n_spheres))
    with pytest.raises(ValueError, match="single treelet"):
        build_treelets(ds.wide_nodes.numpy(), ds.prim_rows.numpy(),
                       100000, 1000000)


def _tmax(finite, ds):
    """No cut-off, or one between 0.3 and 1.2 scene diagonals (the rays
    start 0.75 diagonals from the scene's centre)."""
    diag = float(torch.linalg.norm(ds.world_hi - ds.world_lo))
    gen = np.random.default_rng(1)
    return (gen.uniform(0.3 * diag, 1.2 * diag, N_RAYS).astype(np.float32)
            if finite else np.full(N_RAYS, np.inf, np.float32))


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("finite", [False, True], ids=["inf", "finite_tmax"])
def test_hit_records_match_jax_and_single_level(scene, any_hit, finite):
    _, (ds_j, st_j), _, (ds, st), o, d = scene
    tmax = _tmax(finite, ds)
    hj, _ = jax_intersect_wide(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(tmax), any_hit=any_hit)
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)
    before = traverse_treelets.launches
    h2, s2 = intersect_treelets_cuda(ds, st, to, td, tt, any_hit=any_hit)
    assert traverse_treelets.launches == before  # CPU: the plain version
    h1, s1 = trav.intersect_wide(ds, st, to, td, tt, any_hit=any_hit)

    valid = np.asarray(hj.valid)
    assert valid.sum() > (20 if finite else 100)
    np.testing.assert_array_equal(valid, h2.valid.numpy())
    np.testing.assert_array_equal(np.asarray(hj.prim), h2.prim.numpy())
    tri = valid & (np.asarray(hj.prim) < st.n_tris)
    quad = valid & ~tri
    assert testscenes.ulp_distance(hj.t, h2.t.numpy())[tri].max() <= 4
    for name in ("b1", "b2"):
        diff = np.abs(np.asarray(getattr(hj, name)) - getattr(h2, name).numpy())
        assert diff[tri].max() <= BARY_TOL
    if quad.any():
        np.testing.assert_allclose(h2.t.numpy()[quad], np.asarray(hj.t)[quad],
                                   rtol=QUADRIC_T_RTOL)
        # p_obj = o_obj + t * d_obj with t up to 40 here: t's last bits
        # show as up to 3.9e-4 absolute (measured)
        np.testing.assert_allclose(h2.p_obj.numpy()[quad],
                                   np.asarray(hj.p_obj)[quad],
                                   rtol=1e-4, atol=1e-3)

    # this package's single-level walker on the same wide tree: same bits
    for name in ("valid", "prim", "t", "b1", "b2"):
        np.testing.assert_array_equal(getattr(h1, name).numpy(),
                                      getattr(h2, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(h1.p_obj.numpy()[valid],
                                  h2.p_obj.numpy()[valid])
    assert bool((s2.leaf_visits <= s1.leaf_visits).all())
    assert bool((s2.prim_tests <= s1.prim_tests).all())
    assert int(s2.prim_tests.sum()) > 0.9 * int(s1.prim_tests.sum())
    assert bool((s2.node_visits >= 1)[tt > 0].all())


def test_node_visits_differ_by_one_leaf_treelet_roots(scene):
    """Counting by hand: a ray's node visits over two levels are its visits
    in the single-level tree plus one for each one-leaf treelet it enters
    (closest hit, no cut-off, so both walks pop the same leaves unless the
    one-leaf root's box test culls, which the leaf counts then show)."""
    _, _, _, (ds, st), o, d = scene
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tt = torch.full((N_RAYS,), float("inf"))
    _, s2 = trav.intersect_two_level(ds, st, to, td, tt)
    _, s1 = trav.intersect_wide(ds, st, to, td, tt)
    extra = (s2.node_visits - s1.node_visits).numpy()
    assert (extra >= 0).all()
    assert (extra <= s1.leaf_visits.numpy()).all()
    same_leaves = (s2.leaf_visits == s1.leaf_visits).numpy()
    assert same_leaves.mean() > 0.5


def test_dead_rays_never_enter_the_tree(scene):
    _, _, _, (ds, st), o, d = scene
    tmax = np.full(N_RAYS, np.inf, np.float32)
    tmax[::2] = 0.0
    hit, stats = trav.intersect_two_level(
        ds, st, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    dead = torch.from_numpy(tmax == 0.0)
    assert not bool(hit.valid[dead].any())
    assert int(stats.node_visits[dead].sum()) == 0
    assert int(stats.node_visits[~dead].min()) >= 1


def test_touched_masks_count_the_rows_read(scene):
    _, _, _, (ds, st), o, d = scene
    to, td = torch.from_numpy(o[:256]), torch.from_numpy(d[:256])
    tt = torch.full((256,), float("inf"))
    masks = [torch.zeros(len(t), dtype=torch.bool)
             for t in (ds.top_nodes, ds.tl_nodes, ds.tl_prims, ds.tl_offsets)]
    _, s = trav.intersect_two_level(ds, st, to, td, tt, touched=masks)
    assert bool(masks[0][0])  # every live ray reads the top root
    assert 0 < int(masks[1].sum()) + int(masks[0].sum()) <= int(s.node_visits.sum())
    assert 0 < int(masks[2].sum()) <= int(s.prim_tests.sum())
    assert 0 < int(masks[3].sum()) <= st.n_treelets
    m1 = [torch.zeros(len(ds.wide_nodes), dtype=torch.bool),
          torch.zeros(len(ds.prim_rows), dtype=torch.bool)]
    _, s1 = trav.intersect_wide(ds, st, to, td, tt, touched=m1)
    assert 0 < int(m1[0].sum()) <= int(s1.node_visits.sum())
    assert int(m1[1].sum()) >= int(masks[2].sum())


def test_against_pallas_stream_kernel_in_interpret_mode(tmp_path):
    """The TPU kernel this one replaces, run as the JAX package's own tests
    run it on the CPU; zero-edge rays are identified and left out (see
    test_torch_traverse.py)."""
    txt = testscenes.triangle_clusters_pbrt(600, 12)
    ds_j, st_j = jax_upload(jax_flatten(jax_parse_string(txt)), two_level=True,
                            treelet_budget=(32, 256))
    ds, st = from_numpy(*testscenes.tables_as_numpy(ds_j, st_j), device="cpu")
    lo, hi = np.asarray(ds_j.world_lo), np.asarray(ds_j.world_hi)
    o, d = testscenes.aimed_rays(1024, 23, lo, hi)
    tmax = np.full(1024, np.inf, np.float32)
    hp, _ = intersect_packets_streamed(ds_j, st_j, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(tmax),
                                       interpret=True)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    ht, _ = trav.intersect_two_level(ds, st, to, td, torch.from_numpy(tmax))
    from tpupt_torch.shapes.triangle import _permute, ray_permutation
    kx, ky, kz, sx, sy, _ = ray_permutation(td)
    zero_edge = torch.zeros(1024, dtype=torch.bool)
    for tid in range(st.n_tris):
        xy = []
        for p in (ds.tri_p0[tid], ds.tri_p1[tid], ds.tri_p2[tid]):
            ax, ay, az = _permute(p - to, kx, ky, kz)
            xy.append((ax - sx * az, ay - sy * az))
        (x0, y0), (x1, y1), (x2, y2) = xy
        e0, e1, e2 = x1 * y2 - y1 * x2, x2 * y0 - y2 * x0, x0 * y1 - y0 * x1
        zero_edge |= (e0 == 0) | (e1 == 0) | (e2 == 0)
    keep = ~zero_edge.numpy()
    assert keep.mean() > 0.99 and ht.valid.sum() > 40
    np.testing.assert_array_equal(np.asarray(hp.valid)[keep], ht.valid.numpy()[keep])
    np.testing.assert_array_equal(np.asarray(hp.prim)[keep], ht.prim.numpy()[keep])
    m = keep & ht.valid.numpy()
    np.testing.assert_allclose(ht.t.numpy()[m], np.asarray(hp.t)[m], rtol=1e-5)


# ------------------------- wrapper and renderer -----------------------------


def test_wrapper_refuses_single_level_tables_and_bad_inputs(scene, tmp_path):
    _, _, _, (ds, st), o, d = scene
    to, td = torch.from_numpy(o[:64]), torch.from_numpy(d[:64])
    tt = torch.full((64,), float("inf"))
    sc = flatten(parse_string(testscenes.random_triangles_pbrt(8, 0)))
    ds1, st1 = upload(sc, device="cpu")
    assert not st1.two_level and ds1.top_nodes.shape == (1, 64)
    with pytest.raises(ValueError, match="two-level"):
        intersect_treelets_cuda(ds1, st1, to, td, tt)
    with pytest.raises(TypeError):
        intersect_treelets_cuda(ds, st, to.double(), td, tt)
    with pytest.raises(ValueError):
        intersect_treelets_cuda(ds, st, to, td, tt[:-1])
    bad = ds._replace(tl_offsets=ds.tl_offsets.long())
    with pytest.raises(TypeError, match="tl_offsets"):
        intersect_treelets_cuda(bad, st, to, td, tt)


def test_upload_switches_to_two_level_by_table_size(monkeypatch):
    from tpupt_torch.scene import device as devmod

    sc = flatten(parse_string(testscenes.triangle_clusters_pbrt(600, 12)))
    _, st = upload(sc, device="cpu")
    assert not st.two_level
    assert pick_traversal(st) is traverse_wide.intersect_wide_cuda
    monkeypatch.setattr(devmod, "TWO_LEVEL_MIN_BYTES", 64 * 1024)
    monkeypatch.setattr(devmod, "TREELET_NODES", 32)
    monkeypatch.setattr(devmod, "TREELET_PRIMS", 256)
    _, st = upload(sc, device="cpu")
    assert st.two_level and st.n_treelets >= 4 and (st.tl_tn, st.tl_tp) == (32, 256)
    assert pick_traversal(st) is intersect_treelets_cuda


@pytest.mark.parametrize("name", ["museum", "clusters_spheres"])
def test_renderer_takes_the_two_level_path(name, tmp_path):
    """The same film through the treelet walker as through the single-level
    walker on the same wide tree; only the node-visit AOV may be larger."""
    _, sc = _parsed(name, tmp_path)
    import dataclasses

    sc = dataclasses.replace(sc, film=dataclasses.replace(sc.film, xres=16, yres=16))
    tables = upload(sc, light_strategy="spatial", device="cpu", two_level=True,
                    treelet_budget=BUDGETS[name])
    r2 = Renderer(sc, device="cpu", tables=tables)
    assert r2._isect is intersect_treelets_cuda
    calls = []

    def single(ds, st, o, d, tmax, any_hit=False):
        calls.append(any_hit)
        return trav.intersect_wide(ds, st, o, d, tmax, any_hit=any_hit)

    f2 = r2.render(spp=1)
    f1 = Renderer(sc, device="cpu", tables=tables, isect=single).render(spp=1)
    assert len(calls) == 2 * (sc.integrator.max_depth + 1)
    np.testing.assert_array_equal(f2.rgb.numpy(), f1.rgb.numpy())
    np.testing.assert_array_equal(f2.weight.numpy(), f1.weight.numpy())
    a2, a1 = f2.aov.numpy(), f1.aov.numpy()
    np.testing.assert_array_equal(a2[..., 3], a1[..., 3])   # path length
    assert (a2[..., 1] <= a1[..., 1]).all() and a2[..., 1].sum() > 0
    assert float(f2.rgb.sum()) > 0


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_card(scene):
    """Needs a CUDA device and nvcc; `python3 chip_smoke.py` runs the same
    comparison at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, _, _, (ds, st), o, d = scene
    dev = torch.device("cuda")
    ds = type(ds)(*[t.to(dev) for t in ds])
    to, td = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    tt = torch.full((N_RAYS,), float("inf"), device=dev)
    before = traverse_treelets.launches
    hk, sk = intersect_treelets_cuda(ds, st, to, td, tt)
    assert traverse_treelets.launches == before + 1
    hp, sp = trav.intersect_two_level(ds, st, to, td, tt)
    assert torch.equal(hk.prim, hp.prim) and torch.equal(hk.t, hp.t)
    assert torch.equal(sk.node_visits, sp.node_visits)
