"""tpupt_torch kd-tree / RBSP / BSP traversal (the module that holds CUDA
kernel K2) against the JAX package, on identical trees and rays.

On the CPU `intersect_kdbsp_cuda` runs the kernel's plain version,
`accel.kdbsp.intersect_kdbsp`, a port of the JAX package's per-ray walker
`tpupt.accel.kdbsp.intersect_kdbsp`. Rays: the 1600 camera rays of the scene
plus 1600 incoherent ones (reversed directions from scattered origins), 30 %
of them with a finite tmax, 10 % dead (tmax 0). Tolerances, and why:

- `valid` and `prim`: exact.
- triangle `t`: <= 8 ulp. XLA's CPU compiler contracts a*b+c inside the
  compiled while-loop, PyTorch's eager kernels do not. Measured worst on
  these rays: 7 ulp (the same hits through the port's BVH walker: 0 ulp, so
  it is the compiler and not the tree). Barycentrics: 5e-6 absolute, as for
  the BVH walker (measured 9.6e-7 here).
- quadric `t`: 2e-5 relative (b*b - 4ac cancels; measured 1.8e-6), `p_obj`
  1e-4 absolute, on quadric hits only (the JAX walker leaves `p_obj` of a
  triangle hit at whatever an earlier quadric test left there).
- counters, on live rays only (the JAX walker lets a dead lane whose origin
  lies inside the world bounds walk down to a leaf; the port lets it leave at
  once, and the path integrator masks dead lanes' counters in both):
  any hit: all three equal on every ray, every tree. Closest hit: the
  projections `dot(o, dir)` are matrix products in the JAX walker and
  term-by-term sums here, and `t` differs in its last bits as said above, so
  a ray whose plane distance or hit sits exactly on a cell's boundary (this
  scene's quads lie on split planes) may visit one cell more or less.
  Measured share of live rays with a differing counter: kdtree 0 % node
  visits, 0.14 % leaf visits / prim tests; rbsp 0-0.17 %; the BSP family up to
  0.6 % node visits, 2.2 % leaf visits, 0.8 % prim tests. Limits: 0.5 % for
  kdtree and rbsp, 3 % for the BSP family, node visits of kdtree exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel import kdbsp as jk
from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt.scene.params import ParamSet as JaxParamSet
from tpupt_torch.accel import kdbsp
from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops import traverse_kdbsp
from tpupt_torch.ops.traverse_kdbsp import intersect_kdbsp_cuda
from tpupt_torch.scene.device import from_numpy, with_alt_accel
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

TRI_T_ULP = 8
BARY_TOL = 5e-6
QUADRIC_T_RTOL = 2e-5
TREES = testscenes.ALT_ACCELERATORS
_IDS = [f"{a}{n or ''}" for a, n in TREES]
_TXT = testscenes.accelerator_scene_pbrt()


def _params(cls, ndirs):
    ps = cls()
    if ndirs:
        ps.add("integer nbDirections", [ndirs])
    return ps


@functools.lru_cache(maxsize=None)
def _base():
    """The scene in both packages, its BVH tables carried across, and rays."""
    sj = jax_flatten(jax_parse_string(_TXT))
    ds_j, st_j = jax_upload(sj)
    ds_t, st_t = from_numpy(*testscenes.tables_as_numpy(ds_j, st_j),
                            device="cpu")
    res = 40
    px, py = np.meshgrid(np.arange(res), np.arange(res), indexing="xy")
    pr = jnp.asarray(np.stack([px.ravel() + 0.5, py.ravel() + 0.5], -1),
                     jnp.float32)
    o, d = jax_generate_rays(0, ds_j.raster_to_camera, ds_j.cam_to_world, pr,
                             jnp.zeros((res * res, 2)), 0.0, 1e6)
    o, d = np.asarray(o), np.asarray(d)
    # mix in incoherent rays: reversed directions from scattered origins
    o = np.concatenate([o, o[::-1] * 0.3 + 0.2]).astype(np.float32)
    d = np.concatenate([d, -d[::-1]]).astype(np.float32)
    rng = np.random.default_rng(5)
    tmax = np.full(len(o), np.inf, np.float32)
    finite = rng.random(len(o)) < 0.3
    tmax[finite] = rng.uniform(1, 8, finite.sum()).astype(np.float32)
    tmax[rng.random(len(o)) < 0.1] = 0.0
    return sj, (ds_j, st_j), (ds_t, st_t), o, d, tmax


@functools.lru_cache(maxsize=None)
def _tree(accel, ndirs):
    """The JAX package's tree and the port's tables of the same tree: carried
    across from the JAX package's arrays for every other tree of the list,
    built by the port's own builders for the rest."""
    sj, _, (ds_t, st_t), _, _, _ = _base()
    nodes, dirs, max_leaf, _ = jk.build_alt_accel(
        sj, accel, _params(JaxParamSet, ndirs))
    if TREES.index((accel, ndirs)) % 2 == 0:
        carried = {k: np.asarray(v) for k, v in nodes.items() if k != "pack"}
        port = with_alt_accel(ds_t, st_t, carried, np.asarray(dirs))
    else:
        st_scene = flatten(parse_string(_TXT))
        own, own_dirs, _, _ = kdbsp.build_alt_accel(
            st_scene, accel, _params(ParamSet, ndirs))
        port = with_alt_accel(ds_t, st_t, own, own_dirs)
    return (nodes, dirs, max_leaf), port


def _torch_rays():
    _, _, _, o, d, tmax = _base()
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("accel,ndirs", TREES, ids=_IDS)
def test_walker_matches_jax_walker(accel, ndirs, any_hit):
    _, (ds_j, st_j), _, o, d, tmax = _base()
    (nodes, dirs, max_leaf), (ds_t, st_t) = _tree(accel, ndirs)
    hj, sj = jk.intersect_kdbsp(nodes, dirs, ds_j, st_j, jnp.asarray(o),
                                jnp.asarray(d), jnp.asarray(tmax), max_leaf,
                                any_hit=any_hit)
    before = traverse_kdbsp.launches
    ht, stt = intersect_kdbsp_cuda(ds_t, st_t, *_torch_rays(), any_hit=any_hit)
    assert traverse_kdbsp.launches == before  # CPU tensors: the plain version

    valid = np.asarray(hj.valid)
    prim = np.asarray(hj.prim)
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.prim.numpy(), prim)
    assert 500 < valid.sum() < len(valid)
    live = tmax > 0
    assert not valid[~live].any()

    is_tri = valid & (prim < st_t.n_tris)
    is_quad = valid & ~is_tri
    assert is_tri.sum() > 300 and is_quad.sum() > 20
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    assert testscenes.ulp_distance(tj[is_tri], tt[is_tri]).max() <= TRI_T_ULP
    np.testing.assert_allclose(tt[is_quad], tj[is_quad], rtol=QUADRIC_T_RTOL)
    np.testing.assert_array_equal(tt[~valid], tj[~valid])
    for name in ("b1", "b2"):
        a, b = np.asarray(getattr(hj, name)), getattr(ht, name).numpy()
        assert np.abs(a - b)[is_tri].max() <= BARY_TOL, name
    assert np.abs(np.asarray(hj.p_obj) - ht.p_obj.numpy())[is_quad].max() <= 1e-4

    limit = 0.005 if accel in ("kdtree", "rbsp") else 0.03
    for name in ("node_visits", "leaf_visits", "prim_tests"):
        a, b = np.asarray(getattr(sj, name)), getattr(stt, name).numpy()
        assert not b[~live].any(), name   # dead lanes leave at once
        differ = (a != b)[live].mean()
        if any_hit or (accel == "kdtree" and name == "node_visits"):
            assert differ == 0.0, (name, differ)
        else:
            assert differ <= limit, (name, differ)
        assert abs(int(a[live].sum()) - int(b[live].sum())) \
            <= limit * a[live].sum(), name
    assert int(stt.node_visits.sum()) > 10 * live.sum()


@pytest.mark.parametrize("accel,ndirs", TREES, ids=_IDS)
def test_walker_matches_the_ports_bvh_walker(accel, ndirs):
    """Every tree finds the hit the wide BVH finds (the port's copy of
    test_kdbsp_traversal_matches_bvh). `t` to rtol=1e-3 as there; measured: 0
    difference, the leaf test is the same code on the same prim rows."""
    _, (ds_t, st_t) = _tree(accel, ndirs)
    o, d, _ = _torch_rays()
    inf = torch.full((o.shape[0],), float("inf"))
    ref, _ = trav.intersect_wide(ds_t, st_t, o, d, inf)
    hit, stats = kdbsp.intersect_kdbsp(ds_t, st_t, o, d, inf)
    assert torch.equal(hit.valid, ref.valid) and torch.equal(hit.prim, ref.prim)
    np.testing.assert_allclose(hit.t.numpy()[ref.valid.numpy()],
                               ref.t.numpy()[ref.valid.numpy()], rtol=1e-3)
    quad = ref.valid & (ref.prim >= st_t.n_tris)
    torch.testing.assert_close(hit.p_obj[quad], ref.p_obj[quad], rtol=0,
                               atol=1e-6)
    occ, _ = kdbsp.intersect_kdbsp(ds_t, st_t, o, d, inf, any_hit=True)
    assert torch.equal(occ.valid, ref.valid)
    assert int(stats.leaf_visits.sum()) > 0


def test_touched_masks_mark_the_rows_some_ray_read():
    _, (ds_t, st_t) = _tree("rbsp", 7)
    o, d, tmax = _torch_rays()
    masks = (torch.zeros(ds_t.alt_nodes.shape[0], dtype=torch.bool),
             torch.zeros(ds_t.alt_prim_rows.shape[0], dtype=torch.bool))
    a = kdbsp.intersect_kdbsp(ds_t, st_t, o, d, tmax, touched=masks)
    b = kdbsp.intersect_kdbsp(ds_t, st_t, o, d, tmax)
    assert torch.equal(a[0].prim, b[0].prim)
    assert torch.equal(a[1].node_visits, b[1].node_visits)
    assert masks[0][0] and 10 < int(masks[0].sum()) <= masks[0].numel()
    # pad rows (copies that 4-align a leaf run, and the zero tail) stay unread
    ints = ds_t.alt_nodes.view(torch.int32).numpy()
    first, nprims, leaf = ints[:, 5], ints[:, 6], ints[:, 4] == 1
    real = np.zeros(masks[1].numel(), bool)
    for f, c in zip(first[leaf], nprims[leaf]):
        real[f:f + c] = True
    assert not masks[1].numpy()[~real].any() and masks[1].any()


def test_node_rows_agree_with_the_flat_arrays():
    """The tables on the device (node rows, prim rows) against the flat
    arrays of the JAX package's builder, which stay on the host."""
    for accel, ndirs in (("rbsp", 13), ("bsppaperkd", None)):
        (nodes, dirs, max_leaf), (ds_t, st_t) = _tree(accel, ndirs)
        assert set(f for f in ds_t._fields if f.startswith("alt_")) == {
            "alt_nodes", "alt_prim_rows"}
        ints = ds_t.alt_nodes.view(torch.int32).numpy()
        flags = np.asarray(nodes["flags"])
        dirs = np.asarray(dirs, np.float32)
        per_node = "ndir" in nodes
        leaf = (flags == 1) if per_node else (flags >= len(dirs))
        np.testing.assert_array_equal(ints[:, 4] == 1, leaf)
        np.testing.assert_array_equal(ints[:, 4] == 0, ~leaf)
        np.testing.assert_array_equal(ints[:, 5], np.asarray(nodes["above"]))
        np.testing.assert_array_equal(ints[:, 6], np.asarray(nodes["nprims"]))
        np.testing.assert_array_equal(ds_t.alt_nodes[:, 3].numpy(),
                                      np.asarray(nodes["split"], np.float32))
        nd = (np.asarray(nodes["ndir"], np.float32) if per_node else
              dirs[np.minimum(flags, len(dirs) - 1)])
        np.testing.assert_array_equal(ds_t.alt_nodes[:, 0:3].numpy(), nd)
        np.testing.assert_array_equal(ds_t.alt_prim_rows.numpy(),
                                      np.asarray(nodes["prim_rows"]))
        assert st_t.alt_tree_depth == 16 and st_t.alt_max_leaf == max_leaf


def test_a_tree_deeper_than_the_stack_raises(monkeypatch):
    _, (ds_t, st_t) = _tree("kdtree", None)
    o, d, tmax = _torch_rays()
    monkeypatch.setattr(kdbsp, "KD_STACK", st_t.alt_tree_depth)
    with pytest.raises(ValueError, match="too deep"):
        intersect_kdbsp_cuda(ds_t, st_t, o, d, tmax)
    # and a push past the capacity is caught, not dropped
    monkeypatch.setattr(kdbsp, "check_tree", lambda st: None)
    monkeypatch.setattr(kdbsp, "KD_STACK", 2)
    with pytest.raises(RuntimeError, match="stack overflow"):
        kdbsp.intersect_kdbsp(ds_t, st_t, o, d, tmax)


def test_wrapper_refuses_tables_without_a_tree_and_bad_rays():
    _, _, (ds_t, st_t), _, _, _ = _base()
    o, d, tmax = _torch_rays()
    with pytest.raises(ValueError, match="without kd/BSP tables"):
        intersect_kdbsp_cuda(ds_t, st_t, o, d, tmax)
    _, (ds_k, st_k) = _tree("kdtree", None)
    with pytest.raises(TypeError, match="float32"):
        intersect_kdbsp_cuda(ds_k, st_k, o.double(), d, tmax)
    with pytest.raises(ValueError, match="contiguous"):
        intersect_kdbsp_cuda(ds_k, st_k, o, d.T.contiguous().T, tmax)
    hit, _ = intersect_kdbsp_cuda(ds_k, st_k, o[:0], d[:0], tmax[:0])
    assert hit.t.shape == (0,)


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_card():
    """Needs a CUDA device and nvcc; `python3 chip_smoke.py` runs the same
    comparison over six trees and three scenes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, (ds, st) = _tree("rbsp", 7)
    dev = torch.device("cuda")
    ds = type(ds)(*[t.to(dev) for t in ds])
    o, d, tmax = (x.to(dev) for x in _torch_rays())
    before = traverse_kdbsp.launches
    hk, sk = intersect_kdbsp_cuda(ds, st, o, d, tmax)
    assert traverse_kdbsp.launches == before + 1
    hp, sp = kdbsp.intersect_kdbsp(ds, st, o, d, tmax)
    assert torch.equal(hk.prim, hp.prim) and torch.equal(hk.t, hp.t)
    assert torch.equal(sk.node_visits, sp.node_visits)
    traverse_kdbsp.check_stack_depth()
