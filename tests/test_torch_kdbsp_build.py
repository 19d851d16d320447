"""kd-tree / RBSP / BSP builders of tpupt_torch against the JAX package's, on
the same seeded scene: both packages hold their own copy of the native
builders and of the host-side packing, and every table must be array-equal
(no tolerance: the same C++ and numpy arithmetic on the same inputs)."""

import numpy as np
import pytest
import torch

from tpupt.accel import kdbsp as jk
from tpupt.native import polytope_cut_area as jax_polytope_cut_area
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt.scene.params import ParamSet as JaxParamSet
from tpupt_torch import native
from tpupt_torch.accel import kdbsp
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

S2, S3 = np.sqrt(2), np.sqrt(3)
_IDS = [f"{a}{n or ''}" for a, n in testscenes.ALT_ACCELERATORS]


def _params(cls, ndirs):
    ps = cls()
    if ndirs:
        ps.add("integer nbDirections", [ndirs])
    return ps


@pytest.fixture(scope="module")
def scenes():
    txt = testscenes.accelerator_scene_pbrt()
    return jax_flatten(jax_parse_string(txt)), flatten(parse_string(txt))


def _both(scenes, accel, ndirs):
    sj, st = scenes
    return (jk.build_alt_accel(sj, accel, _params(JaxParamSet, ndirs)),
            kdbsp.build_alt_accel(st, accel, _params(ParamSet, ndirs)))


@pytest.mark.parametrize("accel,ndirs", testscenes.ALT_ACCELERATORS, ids=_IDS)
def test_tables_equal_the_jax_packages(scenes, accel, ndirs):
    (nj, dj, mlj, sj), (nt, dt, mlt, stt) = _both(scenes, accel, ndirs)
    assert set(nt) == set(nj) - {"pack"}
    for k in ("flags", "split", "above", "nprims", "prim_ids", "prim_rows",
              "ndir"):
        if k in nj:
            a, b = np.asarray(nj[k]), nt[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            # prim rows hold int bit patterns: compare the bits
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), k)
    np.testing.assert_array_equal(np.asarray(dj), dt)
    assert dt.dtype == np.float32
    assert mlj == mlt
    for k in ("n_nodes", "max_leaf", "n_leaves", "tree_depth", "n_kd_nodes",
              "n_bsp_nodes"):
        assert sj.get(k) == stt.get(k), k
    # leaf runs are 4-aligned and 16 zero rows end the table
    leaf = kdbsp.leaf_mask(nt["flags"], len(dt), "ndir" in nt)
    assert (nt["above"][leaf & (nt["nprims"] > 0)] % 4 == 0).all()
    assert len(nt["prim_rows"]) % 4 == 0
    assert not nt["prim_rows"][-16:].any() and (nt["prim_ids"][-16:] == -1).all()


@pytest.mark.parametrize("accel,ndirs", testscenes.ALT_ACCELERATORS, ids=_IDS)
def test_node_rows_hold_the_jax_packages_tile_values(scenes, accel, ndirs):
    """The port's (K,8) rows, ints as bit patterns, against the JAX package's
    float-coded (K/128, 8, 128) tiles: same direction, split, leaf flag,
    child / first row and prim count for every node."""
    (nj, _, _, _), (nt, dt, _, _) = _both(scenes, accel, ndirs)
    rows = kdbsp.alt_tables(nt, dt)[0]["alt_nodes"]
    k = len(rows)
    assert rows.shape == (k, 8) and rows.dtype == np.float32
    pack = np.asarray(nj["pack"]).transpose(0, 2, 1).reshape(-1, 8)[:k]
    np.testing.assert_array_equal(rows[:, 0:4], pack[:, 0:4])
    np.testing.assert_array_equal(rows.view(np.int32)[:, 4:7],
                                  pack[:, 4:7].astype(np.int32))
    assert not rows[:, 7].any()


@pytest.mark.parametrize("dirs,ts,want", [
    ([], [], 6.0),                                        # unit cube
    ([[1, 0, 0]], [0.5], 4.0),                            # axis cut
    ([[1 / S2, 1 / S2, 0]], [1 / S2], 3 + S2),            # edge-diagonal cut
    ([[1 / S3, 1 / S3, 1 / S3]], [1 / S3], 1.5 + S3 / 2),  # corner cut
    ([[1, 0, 0], [0, 1, 0]], [0.5, 0.5], 2.5),            # two cuts
    ([[1, 0, 0]], [2.0], 6.0),                            # cut outside
    ([[1, 0, 0]], [1.0], 6.0),                            # in-plane cut
    ([[-1, 0, 0]], [-0.5], 4.0),                          # negative direction
])
def test_polytope_cut_area_equals(dirs, ts, want):
    args = ([0, 0, 0], [1, 1, 1], np.array(dirs).reshape(-1, 3), np.array(ts))
    got = native.polytope_cut_area(*args)
    assert got == jax_polytope_cut_area(*args)
    assert abs(got - want) < 1e-9


@pytest.mark.parametrize("n", [3, 7, 9, 13])
def test_direction_sets_equal(n):
    np.testing.assert_array_equal(kdbsp.get_directions(n), jk.get_directions(n))
    assert kdbsp.get_directions(n).shape == (n, 3)


def test_prim_points_equal(scenes):
    from tpupt.accel.bvh import scene_prim_bounds as jax_bounds
    from tpupt_torch.accel.bvh import scene_prim_bounds

    sj, st = scenes
    for a, b in zip(jk.scene_prim_points(sj, *jax_bounds(sj)),
                    kdbsp.scene_prim_points(st, *scene_prim_bounds(st))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("accel,ndirs", [("kdtree", None), ("rbsp", 7),
                                         ("bspcluster", 3), ("bsppaperkd", None)])
def test_tree_tools_give_the_same_output(scenes, accel, ndirs, tmp_path):
    (nj, dj, _, _), (nt, dt, _, _) = _both(scenes, accel, ndirs)
    assert kdbsp.node_type_depth_maps(nt, dt) == jk.node_type_depth_maps(nj, dj)
    jk.dump_tree(nj, dj, tmp_path / "j.txt")
    kdbsp.dump_tree(nt, dt, tmp_path / "t.txt")
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert text.splitlines()[len(dt) + 1] == str(len(nt["flags"]))


def test_raw_builders_equal_on_random_boxes():
    """The three ctypes wrappers by themselves, on random boxes."""
    import tpupt.native as jn

    rng = np.random.default_rng(1)
    c = rng.random((200, 3))
    h = rng.random((200, 3)) * 0.05
    lo, hi = c - h, c + h
    dirs = kdbsp.get_directions(7)
    proj = kdbsp._box_corners(lo, hi) @ dirs.T
    pts, npts = kdbsp._box_corners(lo, hi), np.full(200, 8, np.int32)
    nrm = np.tile([1.0, 0.0, 0.0], (200, 1))
    pairs = [
        (jn.build_kdtree(lo, hi), native.build_kdtree(lo, hi)),
        (jn.build_rbsp(dirs, proj.min(1), proj.max(1), lo.min(0), hi.max(0)),
         native.build_rbsp(dirs, proj.min(1), proj.max(1), lo.min(0), hi.max(0))),
        (jn.build_bsp(pts, npts, nrm, lo.min(0), hi.max(0), policy="random",
                      kd_mode="withkd", k=4),
         native.build_bsp(pts, npts, nrm, lo.min(0), hi.max(0), policy="random",
                          kd_mode="withkd", k=4)),
    ]
    for a, b in pairs:
        assert set(a) == set(b)
        assert set(b["prim_ids"]) == set(range(200))
        for k in a:
            if k != "build_seconds":
                np.testing.assert_array_equal(a[k], b[k], k)


def test_unknown_bsp_policy_raises(scenes):
    with pytest.raises(ValueError, match="unknown accelerator"):
        kdbsp.build_alt_accel(scenes[1], "bspnonsense")
    assert kdbsp.build_alt_accel(scenes[1], "bvh") is None
