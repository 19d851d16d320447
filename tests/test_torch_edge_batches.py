"""tpupt_torch's wide-BVH (K1), kd/BSP (K2) and two-level (K3) traversal
wrappers on the batch shapes a launch must also get right: one ray, every lane dead, and
odd sizes with 10 % and with 98 % of the lanes dead (the shape in which the
re-queue driver calls K3 for the rays whose treelet list overflowed).

On the CPU the wrappers run the kernels' plain versions, which walk each ray
on its own; so a ray's record in an edge batch must equal, to the bit, its
record in a full batch of live rays (every Hit field and the three
counters), and a dead lane (tmax 0) must give the dead record: not valid,
prim -1, t 0 and no node, leaf or prim visited. The kernels are held against
the plain versions on the same batches on the card (the `gpu` test here, and
`python3 chip_smoke.py` at full size). Tolerances: none.
"""

import functools

import numpy as np
import pytest
import torch

from tpupt_torch.accel import kdbsp
from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops import traverse_kdbsp, traverse_treelets, traverse_wide
from tpupt_torch.ops.traverse_kdbsp import intersect_kdbsp_cuda
from tpupt_torch.ops.traverse_treelets import intersect_treelets_cuda
from tpupt_torch.ops.traverse_wide import intersect_wide_cuda
from tpupt_torch.scene.device import upload, with_alt_accel
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

KD_TREES = {"kdtree": ("kdtree", None), "rbsp3": ("rbsp", 3)}
N_FULL = 2003
COUNTERS = ("node_visits", "leaf_visits", "prim_tests")
# (rays, dead share): the rays are the first n of the full batch
BATCHES = {"one_ray": (1, 0.0), "all_dead": (67, 1.0),
           "odd_10pct_dead": (1001, 0.1), "odd_98pct_dead": (999, 0.98)}


@functools.lru_cache(maxsize=None)
def _wide_tables():
    sc = flatten(parse_string(testscenes.accelerator_scene_pbrt()))
    return upload(sc, device="cpu")


@functools.lru_cache(maxsize=None)
def _kd_tables(name):
    accel, ndirs = KD_TREES[name]
    sc = flatten(parse_string(testscenes.accelerator_scene_pbrt()))
    ds, st = upload(sc, device="cpu")
    ps = ParamSet()
    if ndirs:
        ps.add("integer nbDirections", [ndirs])
    nodes, dirs, _, _ = kdbsp.build_alt_accel(sc, accel, ps)
    return with_alt_accel(ds, st, nodes, dirs)


@functools.lru_cache(maxsize=None)
def _two_level_tables():
    sc = flatten(parse_string(testscenes.triangle_clusters_pbrt(
        600, 12, 6, lights=True)))
    return upload(sc, device="cpu", two_level=True, treelet_budget=(16, 128))


def _tables(kind):
    if kind == "wide":
        return (_wide_tables(), intersect_wide_cuda, trav.intersect_wide,
                traverse_wide)
    if kind == "two_level":
        return (_two_level_tables(), intersect_treelets_cuda,
                trav.intersect_two_level, traverse_treelets)
    return (_kd_tables(kind), intersect_kdbsp_cuda, kdbsp.intersect_kdbsp,
            traverse_kdbsp)


def _full_batch(ds, seed):
    """N_FULL live rays aimed into the scene, 30 % with a finite tmax."""
    o, d = testscenes.aimed_rays(N_FULL, seed, ds.world_lo.numpy(),
                                 ds.world_hi.numpy())
    gen = np.random.default_rng(seed)
    tmax = np.full(N_FULL, np.inf, np.float32)
    finite = gen.random(N_FULL) < 0.3
    tmax[finite] = gen.uniform(0.5, 8.0, finite.sum()).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


def _edge_batch(o, d, tmax, ref_hit, n, dead_share, seed):
    """The first n rays (from the first ray that hits, for one ray), a
    seeded `dead_share` of them with tmax 0; and their indices."""
    start = int(torch.nonzero(ref_hit.valid)[0]) if n == 1 else 0
    idx = torch.arange(start, start + n)
    dead = torch.from_numpy(
        np.random.default_rng(seed).random(n) < dead_share)
    t = torch.where(dead, 0.0, tmax[idx]).contiguous()
    return o[idx].contiguous(), d[idx].contiguous(), t, idx, dead


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def _check_edge_batch(out, ref, idx, dead):
    (hit, stats), (rhit, rstats) = out, ref
    live = ~dead
    for name in trav.Hit._fields:
        a, b = getattr(hit, name), getattr(rhit, name)[idx]
        assert torch.equal(_bits(a[live]), _bits(b[live])), name
    for name in COUNTERS:
        a, b = getattr(stats, name), getattr(rstats, name)[idx]
        assert torch.equal(a[live], b[live]), name
        assert not a[dead].any(), name
    assert not hit.valid[dead].any()
    assert (hit.prim[dead] == -1).all()
    assert (hit.t[dead] == 0).all()


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("kind", ["wide", "kdtree", "rbsp3", "two_level"])
def test_edge_batch_equals_the_full_batch_ray_by_ray(kind, batch):
    (ds, st), wrapper, plain, mod = _tables(kind)
    o, d, tmax = _full_batch(ds, 11)
    n, dead_share = BATCHES[batch]
    for any_hit in (False, True):
        ref = plain(ds, st, o, d, tmax, any_hit=any_hit)
        assert bool(ref[0].valid.any()) and not bool(ref[0].valid.all())
        eo, ed, et, idx, dead = _edge_batch(o, d, tmax, ref[0], n,
                                            dead_share, 3 + n)
        if 0.0 < dead_share < 1.0:
            assert dead.any() and not dead.all()
        before = mod.launches
        out = wrapper(ds, st, eo, ed, et, any_hit=any_hit)
        assert mod.launches == before   # CPU tensors: the plain version
        assert out[0].t.shape == (n,)
        _check_edge_batch(out, ref, idx, dead)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["wide", "kdtree", "rbsp3", "two_level"])
def test_kernels_on_edge_batches_on_card(kind):
    """Needs a CUDA device and nvcc; `python3 chip_smoke.py` runs the same
    comparison at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    (ds, st), wrapper, plain, mod = _tables(kind)
    o, d, tmax = _full_batch(ds, 11)
    ref = plain(ds, st, o, d, tmax)
    ds = type(ds)(*[t.to(dev) for t in ds])
    for n, dead_share in BATCHES.values():
        rays = _edge_batch(o, d, tmax, ref[0], n, dead_share, 3 + n)[:3]
        eo, ed, et = (x.to(dev) for x in rays)
        for any_hit in (False, True):
            want = plain(ds, st, eo, ed, et, any_hit=any_hit)
            before = mod.launches
            got = wrapper(ds, st, eo, ed, et, any_hit=any_hit)
            assert mod.launches == before + 1
            for name in trav.Hit._fields:
                assert torch.equal(_bits(getattr(got[0], name)),
                                   _bits(getattr(want[0], name))), name
            for name in COUNTERS:
                assert torch.equal(getattr(got[1], name),
                                   getattr(want[1], name)), name
    if kind == "wide":
        traverse_wide.check_stack_depth()
    elif kind != "two_level":
        traverse_kdbsp.check_stack_depth()
