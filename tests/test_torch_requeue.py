"""tpupt_torch's re-queue traversal (the module that holds CUDA kernels
`bin_rays` and `walk_pairs`) against the JAX package's
(`tpupt.ops.traverse_requeue`) and against the port's own two-level walker.

Scenes: the 400-triangle cluster scene of tests/test_smoke_fast.py, rebuilt
from the same seed (`testscenes.triangle_clusters_pbrt(400, 8)` draws the
same triangles) and cut at treelet capacities (32, 256), and every quadric
kind among 300 triangles cut at (4, 128). Each package uploads the scene
itself; both cut it into the same treelets and number them alike
(tests/test_torch_treelets.py holds the top tiles' treelet ids against the
port's metas), so treelet ids are compared directly. On the CPU the wrappers
run the kernels' plain versions. Tolerances, and why:

- per-ray lists against the JAX package's TPU kernel (interpret mode), on
  live rays: the port's lists, as they come, against the JAX package's put
  through a stable sort by entry t (the port keeps the same first records
  of the walk and orders them by (entry t, walk order)): treelet ids and
  overflow counts exact; entry t within 1 ulp (the slab products are the
  same operations; the entries are only sort keys). The port records, in
  the TPU lane's order, only the boxes its own ray hits; a dead lane
  records nothing here and whatever it stands in there, so dead lanes are
  left out.
- the driver's passes, built from the lists' columns, against the passes
  as they were built before the lists came in entry t order (a rank mask
  over walk-order lists, all N * R slots sorted in each pass), fed the JAX
  package's walk-order lists: each ray's packed word, the winners'
  payloads, the counters after each pass and the final `Hit` and counters
  equal to the bit.
- the driver against the port's two-level walker: `valid` exact; closest hit
  `prim`, `t`, `p_obj` and the barycentrics of triangle hits equal to the
  bit, except on rays where the two find different prims at exactly the
  same t (a hit on an edge two triangles share, found in another order:
  counted, at most 1 % of the hits); a quadric hit's b1 / b2 are whatever an
  earlier triangle hit of the same walk left there, and the walks differ.
  Any hit: `valid` exact and t 0 on every hit, as in the JAX package.
  `truncated` zero: one thread a pair defers no pair.
- the driver against the JAX package's driver (interpret mode, 128 rays):
  `valid` exact, `t` to rtol 2e-4 / atol 1e-5, the bound of the JAX
  package's own test (tests/test_smoke_fast.py), which compares its driver
  with its walker.
- a render through the driver: film equal to the default render's pixel for
  pixel (the hits are the same); only the node-visit AOV differs (the
  re-queue walk counts no top-tree steps).
- `walk_pairs`' contract, on the port alone (no JAX call): each ray's packed
  word (bits of t) << 32 | slot takes the first of two pairs with equal t
  and, from a later pass, only a strictly smaller t; a ray without pairs
  keeps tmax (inf included) and no slot; the rank mask of the old pass
  building picks the records a stable sort by entry t puts first, ties and
  empty records included; the
  counters a pass adds to a ray equal the sums over its pairs walked one by
  one; a live count larger than the pairs walks the pairs there are, and a
  used work counter walks nothing. All exact.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.vecmath import ray_inv_d as jax_ray_inv_d
from tpupt.ops import traverse_requeue as jrq
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import traverse as trav
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.ops import traverse_requeue
from tpupt_torch.ops.traverse_requeue import (bin_rays_cuda,
                                              intersect_requeue,
                                              walk_pairs_cuda)
from tpupt_torch.scene.device import upload
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

N_RAYS = 384
TOP_ROWS = 32
TIE_SHARE = 0.01
SCENES = {"clusters": (lambda: testscenes.triangle_clusters_pbrt(400, 8),
                       (32, 256)),
          "quadrics": (lambda: testscenes.quadric_kinds_pbrt(n_tris=300),
                       (4, 128))}


def _rays_at_prims(ds, st, n, seed):
    """Rays from a sphere 0.75 scene diagonals around the scene's centre,
    every other one aimed at a random triangle's centroid (the clusters fill
    little of their box), the rest at random points of the box."""
    lo, hi = ds.world_lo.numpy(), ds.world_hi.numpy()
    o, d = testscenes.aimed_rays(n, seed, lo, hi)
    rng = np.random.default_rng(seed + 1)
    pick = rng.integers(0, st.n_tris, n // 2)
    target = (ds.tri_p0.numpy()[pick] + ds.tri_p1.numpy()[pick]
              + ds.tri_p2.numpy()[pick]) / 3.0
    aim = target - o[: n // 2]
    d[: n // 2] = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return o, np.ascontiguousarray(d, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _scene(name):
    text, budget = SCENES[name]
    txt = text()
    jx = jax_upload(jax_flatten(jax_parse_string(txt)), two_level=True,
                    treelet_budget=budget)
    ds, st = upload(flatten(parse_string(txt)), device="cpu", two_level=True,
                    treelet_budget=budget)
    assert st.two_level and st.n_treelets >= 8
    assert st.n_treelets == jx[1].n_treelets
    o, d = _rays_at_prims(ds, st, N_RAYS, 19)
    return name, jx, (ds, st), o, d


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    return _scene(request.param)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------ (a) per-ray lists ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_lists(name, r_list, dead_every):
    """(tid, tnear, ovf) numpy of `_bin_rays(..., interpret=True)` (kernel
    `_kernel_top_perlane`) for the scene's rays in one 1024-lane packet,
    every `dead_every`-th ray dead (tmax 0, none for 0), the rest with tmax
    inf: each ray's treelets in walk order."""
    _, (ds_j, _), _, o, d = _scene(name)
    tmax = _tmax(dead_every)
    pad = 1024 - N_RAYS
    oj = np.concatenate([o, np.ones((pad, 3), np.float32)])
    dj = np.concatenate([d, np.ones((pad, 3), np.float32)])
    tj = np.concatenate([tmax, np.zeros(pad, np.float32)])
    inv = np.asarray(jax_ray_inv_d(jnp.asarray(dj)))

    def pk(x):
        return jnp.asarray(x.reshape(1, 8, 128))

    # the top tiles padded to one shape for both scenes, with rows no node
    # points to: the jitted kernel, whose compile is most of this test's
    # time, then serves both
    top = np.asarray(ds_j.top_tiles)
    assert len(top) <= TOP_ROWS
    top = np.pad(top, ((0, TOP_ROWS - len(top)),) + ((0, 0),) * (top.ndim - 1))
    out = jrq._bin_rays(
        jnp.asarray(top), pk(oj[:, 0]), pk(oj[:, 1]), pk(oj[:, 2]),
        pk(inv[:, 0]), pk(inv[:, 1]), pk(inv[:, 2]), pk(tj),
        r_list=r_list, interpret=True)
    return tuple(np.asarray(a)[:N_RAYS] for a in out)


def _tmax(dead_every):
    tmax = np.full(N_RAYS, np.inf, np.float32)
    if dead_every:
        tmax[::dead_every] = 0.0
    return tmax


def _by_entry_t(tid, tnear):
    """Each list put through a stable sort by entry t."""
    order = np.argsort(tnear, axis=1, kind="stable")
    return (np.take_along_axis(tid, order, 1),
            np.take_along_axis(tnear, order, 1))


@pytest.mark.parametrize("r_list", [16, 2])
def test_lists_match_the_pallas_kernel_in_interpret_mode(scene, r_list):
    """`bin_rays` against `_bin_rays(..., interpret=True)` (kernel
    `_kernel_top_perlane`) on one 1024-lane packet; every eighth ray dead.
    The port's lists are compared as they come, the JAX package's (walk
    order) after a stable sort by entry t."""
    name, _, (ds, st), o, d = scene
    tmax = _tmax(8)
    tid_j, tn_j, ovf_j = _jax_lists(name, r_list, 8)
    before = dict(traverse_requeue.launches)
    tid, tn, ovf = bin_rays_cuda(ds, st, *_torch(o, d, tmax), r_list=r_list)
    assert traverse_requeue.launches == before   # CPU: the plain version

    live = tmax > 0
    tid_j, tn_j = _by_entry_t(tid_j, tn_j)
    tid, tn = tid.numpy(), tn.numpy()
    np.testing.assert_array_equal(tid[live], tid_j[live])
    np.testing.assert_array_equal(ovf.numpy()[live], ovf_j[live])
    assert testscenes.ulp_distance(tn[live], tn_j[live]).max() <= 1
    assert (tid[~live] == -1).all() and (ovf.numpy()[~live] == 0).all()
    assert (tid[live] >= 0).any(1).mean() > 0.2
    # the port's lists are really in entry t order, empty records last
    assert (np.diff(tn, axis=1) >= 0).all()
    if r_list == 2 and name == "quadrics":
        # lists overflow at 2 (the cluster scene's 8 treelets lie apart: its
        # rays seldom cross three)
        assert (ovf.numpy() > 0).sum() > 10


# ------------------------ (b) against the two-level walker -------------------


CASES = ["closest", "any", "cut_tmax", "dead_lanes", "r_list_2"]


def _compare(out, ref, any_hit, n_tris):
    (h, s), (hp, _) = out, ref
    np.testing.assert_array_equal(h.valid.numpy(), hp.valid.numpy())
    assert int(s.truncated.sum()) == 0
    valid = hp.valid.numpy()
    if any_hit:
        assert (h.t.numpy()[valid] == 0).all()
        return 0
    prim, prim_p = h.prim.numpy(), hp.prim.numpy()
    same = valid & (prim == prim_p)
    ties = valid & (prim != prim_p)
    np.testing.assert_array_equal(h.t.numpy()[valid], hp.t.numpy()[valid])
    tri = same & (prim_p < n_tris)
    for f in ("b1", "b2"):
        np.testing.assert_array_equal(getattr(h, f).numpy()[tri],
                                      getattr(hp, f).numpy()[tri])
    np.testing.assert_array_equal(h.p_obj.numpy()[same], hp.p_obj.numpy()[same])
    assert ties.sum() <= TIE_SHARE * valid.sum()
    return int(ties.sum())


@pytest.mark.parametrize("case", CASES)
def test_driver_matches_the_two_level_walker(scene, case):
    name, _, (ds, st), o, d = scene
    any_hit = case == "any"
    tmax = np.full(N_RAYS, np.inf, np.float32)
    if case == "cut_tmax":
        diag = float(torch.linalg.norm(ds.world_hi - ds.world_lo))
        tmax = np.random.default_rng(2).uniform(
            0.1 * diag, 0.8 * diag, N_RAYS).astype(np.float32)
    if case == "dead_lanes":
        tmax[::3] = 0.0
    r_list = 2 if case == "r_list_2" else 16
    to, td, tt = _torch(o, d, tmax)
    before = dict(traverse_requeue.launches)
    out = intersect_requeue(ds, st, to, td, tt, any_hit=any_hit, r_list=r_list)
    assert traverse_requeue.launches == before   # CPU: the plain versions
    ref = trav.intersect_two_level(ds, st, to, td, tt, any_hit=any_hit)
    _compare(out, ref, any_hit, st.n_tris)
    hit, stats = out
    assert int(hit.valid.sum()) > 20
    live = tt > 0
    assert int(stats.node_visits[live].sum()) > 0
    if case == "dead_lanes":
        dead = ~live
        assert not bool(hit.valid[dead].any())
        assert int(stats.node_visits[dead].sum()) == 0
    if case == "r_list_2" and name == "quadrics":
        _, _, ovf = trav.bin_rays(ds, st, to, td, tt, 2)
        assert int((ovf > 0).sum()) > 10   # the K3 fallback took these


def test_driver_plain_mode_is_the_same_function(scene):
    """The driver's pass loop over the plain versions (what chip_smoke.py
    renders the comparison with) and `intersect_requeue` over the wrappers
    give the same records on the CPU."""
    _, _, (ds, st), o, d = scene
    to, td, tt = _torch(o, d, np.full(N_RAYS, np.inf, np.float32))
    a, sa = intersect_requeue(ds, st, to, td, tt, r_list=2)
    b, sb = traverse_requeue._requeue(
        trav.bin_rays, trav.walk_pairs, trav.intersect_two_level,
        ds, st, to, td, tt, r_list=2)
    for x, y in zip(list(a) + list(sa), list(b) + list(sb)):
        assert torch.equal(x, y)


# ------------------------ (c) against the JAX package's driver ---------------


def test_driver_matches_the_jax_drivers_in_interpret_mode():
    """128 rays through `intersect_packets_requeue(..., interpret=True)` on
    the cluster scene, with at most 4 treelets a 1024-lane chunk (its
    `segs`; 16 by default): compiling the interpreted chunk kernel, whose
    segment loop is unrolled, takes most of this test's time, and the JAX
    package's third pass takes what a chunk defers (its `truncated` is
    checked to be 0, so no pair was left unwalked)."""
    _, (ds_j, st_j), (ds, st), o, d = _scene("clusters")
    o, d = o[:128], d[:128]
    inf = np.full(128, np.inf, np.float32)
    hj, sj = jrq.intersect_packets_requeue(ds_j, st_j, jnp.asarray(o),
                                           jnp.asarray(d), jnp.asarray(inf),
                                           interpret=True, segs=4)
    ht, stt = intersect_requeue(ds, st, *_torch(o, d, inf))
    valid = np.asarray(hj.valid)
    assert valid.sum() > 20
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_allclose(ht.t.numpy()[valid], np.asarray(hj.t)[valid],
                               rtol=2e-4, atol=1e-5)
    assert int(np.asarray(sj.truncated).max()) == 0
    assert int(stt.truncated.max()) == 0


# ------------------------ (d) the render ------------------------------------


def test_render_through_the_driver_equals_the_default_render():
    """16x16 pixels of a small two-level scene: `Renderer(isect=
    intersect_requeue)` against the Renderer's own pick (the two-level
    walker on the CPU), both with counters on."""
    txt = testscenes.triangle_clusters_pbrt(600, 12, 6, lights=True)
    sc = flatten(parse_string(txt))
    sc = dataclasses.replace(sc, film=dataclasses.replace(sc.film, xres=16,
                                                          yres=16))
    tables = upload(sc, light_strategy="spatial", device="cpu",
                    two_level=True, treelet_budget=(16, 128))
    calls = []

    def requeue(*args, any_hit=False, with_stats=True):
        calls.append(any_hit)
        return intersect_requeue(*args, any_hit=any_hit, with_stats=with_stats)

    f1 = Renderer(sc, device="cpu", tables=tables,
                  collect_stats=True).render(spp=1)
    f2 = Renderer(sc, device="cpu", tables=tables, isect=requeue,
                  collect_stats=True).render(spp=1)
    assert len(calls) == 2 * (sc.integrator.max_depth + 1)
    np.testing.assert_array_equal(f2.rgb.numpy(), f1.rgb.numpy())
    np.testing.assert_array_equal(f2.weight.numpy(), f1.weight.numpy())
    a2, a1 = f2.aov.numpy(), f1.aov.numpy()
    np.testing.assert_array_equal(a2[..., 3], a1[..., 3])   # path length
    np.testing.assert_array_equal(a2[..., 1] > 0, a1[..., 1] > 0)
    assert float(f2.rgb.sum()) > 0


def test_render_through_the_driver_follows_collect_stats():
    """A caller's traversal (`Renderer(isect=intersect_requeue)`) gets the
    Renderer's `collect_stats` as its `with_stats`: the driver's plain pass
    loop counts as its kernels do, so without the flag the node-visit,
    leaf-visit and prim-test AOVs stay 0 and with it they count; the film
    and the path-length AOV are the same either way."""
    txt = testscenes.triangle_clusters_pbrt(600, 12, 6, lights=True)
    sc = flatten(parse_string(txt))
    sc = dataclasses.replace(sc, film=dataclasses.replace(sc.film, xres=12,
                                                          yres=12))
    tables = upload(sc, light_strategy="spatial", device="cpu",
                    two_level=True, treelet_budget=(16, 128))
    films = {flag: Renderer(sc, device="cpu", tables=tables,
                            isect=intersect_requeue,
                            collect_stats=flag).render(spp=1)
             for flag in (False, True)}
    off, on = films[False], films[True]
    np.testing.assert_array_equal(off.rgb.numpy(), on.rgb.numpy())
    np.testing.assert_array_equal(off.weight.numpy(), on.weight.numpy())
    np.testing.assert_array_equal(off.aov[..., 3].numpy(),
                                  on.aov[..., 3].numpy())
    assert not off.aov[..., :3].any()
    assert (on.aov[..., :3].sum((0, 1)) > 0).all()
    assert float(on.rgb.sum()) > 0


# ------------------------ wrappers ------------------------------------------


def test_wrappers_refuse_single_level_tables_and_bad_inputs(scene):
    _, _, (ds, st), o, d = scene
    to, td, tt = _torch(o[:8], d[:8], np.full(8, np.inf, np.float32))
    ds1, st1 = upload(flatten(parse_string(
        testscenes.random_triangles_pbrt(8, 0))), device="cpu")
    for fn in (bin_rays_cuda, intersect_requeue):
        with pytest.raises(ValueError, match="two-level"):
            fn(ds1, st1, to, td, tt)
    with pytest.raises(TypeError):
        bin_rays_cuda(ds, st, to.double(), td, tt)
    key = torch.zeros(4, dtype=torch.int32)
    work = torch.zeros(2, dtype=torch.int32)
    best = trav.new_ray_best(tt, 8)
    with pytest.raises(TypeError, match="key"):
        walk_pairs_cuda(ds, st, to, td, key.long(), key, work, tt, best)
    with pytest.raises(ValueError, match="ray"):
        walk_pairs_cuda(ds, st, to, td, key, key[:3], work, tt, best)
    with pytest.raises(ValueError, match="work"):
        walk_pairs_cuda(ds, st, to, td, key, key, work[:1], tt, best)
    with pytest.raises(TypeError, match="best.word"):
        walk_pairs_cuda(ds, st, to, td, key, key, work, tt,
                        best._replace(word=best.word.int()))
    with pytest.raises(ValueError, match="slots"):
        walk_pairs_cuda(ds, st, to, td, key, key, work, tt, best,
                        slot_base=5)
    with pytest.raises(ValueError, match="wave0"):
        intersect_requeue(ds, st, to, td, tt, wave0=0)


# ------------------------ (e) the packed-word contract of walk_pairs --------


def _one_pass(ds, st, o, d, key, ray, t_in, best, slot_base, n_live=None,
              any_hit=False):
    """`walk_pairs` over these (live) pairs, given a live count of
    `n_live` (default: the number of pairs)."""
    n = key.shape[0] if n_live is None else n_live
    work = torch.tensor([n, 0], dtype=torch.int32, device=key.device)
    return walk_pairs_cuda(ds, st, o, d, key.int(), ray.int(), work, t_in,
                           best, slot_base, any_hit=any_hit)


def _ray_with_two_hits(ds, st, o, d, tmax):
    """(ray, [(t, key), ...] nearest first) of the first ray that hits in two
    of its listed treelets at different t, each pair walked alone."""
    tid, _, _ = bin_rays_cuda(ds, st, o, d, tmax)
    for r in range(tid.shape[0]):
        hits = []
        for k in (tid[r][tid[r] >= 0] * 8).tolist():
            best = trav.new_ray_best(tmax, 1)
            _one_pass(ds, st, o, d, torch.tensor([k]), torch.tensor([r]),
                      tmax, best, 0)
            t, has = trav.best_t(best)
            if bool(has[r]):
                hits.append((float(t[r]), k))
        if len({t for t, _ in hits}) >= 2:
            return r, sorted(hits)
    raise AssertionError("no ray hits two treelets")


def test_the_packed_word_picks_the_first_pair_on_equal_t_and_a_later_pass_only_on_a_smaller_t(scene):
    """One ray, pairs given by hand: the same pair twice in one pass (equal
    t) keeps the first slot; a later pass with larger slots replaces a hit
    only with a strictly smaller t, whatever t it starts from; a ray with
    no pairs, and a ray with tmax inf and no hit, keep tmax and no slot."""
    _, _, (ds, st), o, d = scene
    to, td = _torch(o[:48], d[:48])
    tmax = torch.full((48,), float("inf"))
    r, pairs = _ray_with_two_hits(ds, st, to, td, tmax)
    (t_near, k_near), (t_far, k_far) = pairs[0], pairs[-1]
    ray2 = torch.tensor([r, r])

    # equal t in one pass: the first pair in sorted order
    best = trav.new_ray_best(tmax, 16)
    _one_pass(ds, st, to, td, torch.tensor([k_far, k_far]), ray2, tmax,
              best, 4)
    assert int(best.word[r]) & trav.NO_SLOT == 4
    assert float(trav.best_t(best)[0][r]) == t_far

    # a later pass from tmax: an equal t keeps the earlier slot ...
    _one_pass(ds, st, to, td, torch.tensor([k_far]), ray2[:1], tmax, best, 8)
    assert int(best.word[r]) & trav.NO_SLOT == 4
    # ... a smaller t replaces it ...
    _one_pass(ds, st, to, td, torch.tensor([k_near]), ray2[:1], tmax, best, 9)
    assert int(best.word[r]) & trav.NO_SLOT == 9
    assert float(trav.best_t(best)[0][r]) == t_near
    # ... and a larger t does not
    _one_pass(ds, st, to, td, torch.tensor([k_far]), ray2[:1], tmax, best, 10)
    assert int(best.word[r]) & trav.NO_SLOT == 9
    t_b, gid, ridx, b1, b2 = trav.best_hit(best)
    assert float(t_b[r]) == t_near and int(gid[r]) >= 0

    # rays with no pair: tmax inf and no slot, the default record
    others = torch.ones(48, dtype=torch.bool)
    others[r] = False
    assert (best.word[others] == ((0x7F800000 << 32) | trav.NO_SLOT)).all()
    t_b, gid, ridx, b1, b2 = trav.best_hit(best)
    assert torch.isinf(t_b[others]).all() and (gid[others] == -1).all()
    assert not ridx[others].any() and not b1[others].any()
    assert not b2[others].any()
    # a finite tmax is kept to the bit
    cut = torch.full((48,), 2.5)
    assert torch.equal(trav.best_t(trav.new_ray_best(cut, 1))[0], cut)


def first_wave(tnear, wave0: int):
    """(N, R) bool: the records of each list that a stable sort by entry t
    would put in its first `wave0` places, those with fewer than `wave0`
    records of the ray before them in (entry t, slot) order: the ones at or
    below the wave0-th smallest key (bits of entry t) * R + slot, found by
    taking the smallest key out wave0 - 1 times (a key is unique in its
    row). Entry t is never negative (empty records: 3e38), so its bits order
    like it. The driver picked pass 0's records from walk-order lists so
    until the lists came in entry t order; it is the oracle of
    `_passes_as_they_were`."""
    r_list = tnear.shape[1]
    if wave0 >= r_list:
        return torch.ones(tnear.shape, dtype=torch.bool, device=tnear.device)
    slot = torch.arange(r_list, device=tnear.device)
    bits = tnear.contiguous().view(torch.int32).to(torch.int64)
    order = bits * r_list + slot
    rest = order
    for _ in range(wave0 - 1):
        rest = torch.where(rest == rest.amin(1, keepdim=True),
                           torch.iinfo(torch.int64).max, rest)
    return order <= rest.amin(1, keepdim=True)


def test_first_wave_equals_the_stable_sort_selection():
    """The rank mask against the places a stable sort by entry t gives, on
    lists with tied entry t, zero entries and empty records (3e38)."""
    gen = np.random.default_rng(5)
    n, r_list = 400, 16
    tnear = gen.choice([0.0, 0.5, 1.0, 1.5, 2.0], (n, r_list)).astype(np.float32)
    tnear[gen.random((n, r_list)) < 0.3] = 3.0e38
    tnear[::7] = 3.0e38           # whole lists empty
    tnear[1::7] = 1.0             # whole lists tied
    tn = torch.from_numpy(tnear)
    place = torch.argsort(torch.argsort(tn, dim=1, stable=True), dim=1)
    for wave0 in (1, 2, 3, r_list):
        assert torch.equal(first_wave(tn, wave0), place < wave0), wave0


def _passes_as_they_were(ds, st, o, d, tmax, lists, any_hit):
    """The driver's passes as they were built before the lists came in
    entry t order, over walk-order lists (tid, tnear, ovf): pass 0's records
    picked by `first_wave`, every pass building and stably sorting all
    N * R slots, walked by the plain `walk_pairs`. Returns (the rays' best
    hits after each pass, (Hit, TraversalStats))."""
    tid, tnear, ovf = lists
    n, r_list = tid.shape
    octant = traverse_requeue._octants(d)
    p = tid.numel()
    best = trav.new_ray_best(tmax, 2 * p)
    t_best, hit, walked, after = tmax, None, None, []
    for k, wave in enumerate((first_wave(tnear, traverse_requeue.WAVE0),
                              None)):
        live = (tid >= 0) & (tnear < t_best[:, None])
        if walked is not None:
            live = live & ~walked
        if wave is not None:
            live = live & wave
        if any_hit and hit is not None:
            live = live & ~hit[:, None]
        key = torch.where(live, tid * 8 + octant[:, None],
                          trav.pair_sentinel(st)).reshape(-1)
        key, perm = torch.sort(key, stable=True)
        trav.walk_pairs(ds, st, o, d, key, (perm // r_list).to(torch.int32),
                        trav.pair_work(live), t_best, best, k * p,
                        any_hit=any_hit)
        after.append(trav.RayBest(*[x.clone() for x in best]))
        t_best, hit = trav.best_t(best)
        walked = live if walked is None else walked | live
    t_best, gid, ridx, b1, b2 = trav.best_hit(best)
    rem = ((~walked) & (tid >= 0) & (tnear < t_best[:, None])).sum(
        1, dtype=torch.int32)
    if any_hit:
        rem = torch.where(gid >= 0, 0, rem)
    need_fb = ovf > 0
    if any_hit:
        need_fb = need_fb & (gid < 0)
    hit_fb, _ = trav.intersect_two_level(ds, st, o, d,
                                         torch.where(need_fb, tmax, 0.0),
                                         any_hit=any_hit)
    t = torch.where(need_fb, hit_fb.t, t_best)
    gid = torch.where(need_fb, hit_fb.prim, gid)
    b1 = torch.where(need_fb, hit_fb.b1, b1)
    b2 = torch.where(need_fb, hit_fb.b2, b2)
    p_obj = torch.where(need_fb[:, None], hit_fb.p_obj,
                        trav.quadric_hit_point(ds.tl_prims, st, o, d, t_best,
                                               ridx))
    if any_hit:
        t = torch.where(gid >= 0, 0.0, t)
    out = trav.Hit(valid=gid >= 0, t=t, prim=gid, b1=b1, b2=b2, p_obj=p_obj)
    return after, (out, trav.TraversalStats(
        *best[2:], truncated=torch.where(need_fb, 0, rem)))


def as_bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("r_list", [16, 2])
@pytest.mark.parametrize("any_hit", [False, True])
def test_passes_from_list_columns_equal_the_rank_mask_passes(scene, r_list,
                                                             any_hit):
    """The driver's passes (columns [0, wave0) and [wave0, R) of the lists
    in entry t order, N * wave0 and N * (R - wave0) keys sorted) against
    `_passes_as_they_were` over the JAX package's walk-order lists
    (interpret mode), all rays live: after each pass every ray's packed
    word, its winner's payload and its counters, and the final `Hit` and
    counters, equal to the bit."""
    name, _, (ds, st), o, d = scene
    to, td, tt = _torch(o, d, _tmax(0))
    lists = [torch.from_numpy(np.array(a)) for a in _jax_lists(name, r_list, 0)]
    after = []

    def walk(*args, **kw):
        best = walk_pairs_cuda(*args, **kw)
        after.append(trav.RayBest(*[x.clone() for x in best]))
        return best

    out = traverse_requeue._requeue(trav.bin_rays, walk,
                                    trav.intersect_two_level, ds, st, to, td,
                                    tt, any_hit=any_hit, r_list=r_list)
    want_after, want = _passes_as_they_were(ds, st, to, td, tt, lists,
                                            any_hit)
    assert len(after) == len(want_after) == 2
    for k, (a, b) in enumerate(zip(after, want_after)):
        for f in ("word", "node_visits", "leaf_visits", "prim_tests"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (k, f)
        for x, y in zip(trav.best_hit(a), trav.best_hit(b)):
            assert torch.equal(as_bits(x), as_bits(y)), k
    for f, x, y in zip(trav.Hit._fields + trav.TraversalStats._fields,
                       [*out[0], *out[1]], [*want[0], *want[1]]):
        assert torch.equal(as_bits(x), as_bits(y)), f
    assert int(out[0].valid.sum()) > 20
    assert int(trav.best_t(after[0])[1].sum()) > 20   # pass 0 found hits
    if r_list == 2 and name == "quadrics":
        assert int((lists[2] > 0).sum()) > 10   # the fallback took these


@pytest.mark.parametrize("any_hit", [False, True])
def test_counters_are_the_sums_of_the_pairs_walks(scene, any_hit):
    """Each pass of the driver: the counters `walk_pairs` adds to a ray equal
    the sum over its pairs of each pair walked as a ray of its own."""
    _, _, (ds, st), o, d = scene
    to, td, tt = _torch(o, d, np.full(N_RAYS, np.inf, np.float32))
    checked = []

    def walk(ds, st, o, d, key, ray, work, t_in, best, slot_base,
             any_hit, with_stats):
        before = [c.clone() for c in best[2:]]
        m = int(work[0])
        walk_pairs_cuda(ds, st, o, d, key, ray, work, t_in, best,
                        slot_base, any_hit=any_hit, with_stats=with_stats)
        r = ray[:m].long()
        alone = trav.new_ray_best(t_in[r].contiguous(), m)
        _one_pass(ds, st, o[r].contiguous(), d[r].contiguous(),
                  key[:m].contiguous(), torch.arange(m), t_in[r].contiguous(),
                  alone, 0, any_hit=any_hit)
        for b, a, c in zip(before, alone[2:], best[2:]):
            assert torch.equal(c, b.index_add(0, r, a))
        checked.append(m)
        return best

    traverse_requeue._requeue(trav.bin_rays, walk, trav.intersect_two_level,
                              ds, st, to, td, tt, any_hit=any_hit)
    assert len(checked) == 2 and checked[0] > 20


@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_a_live_count_past_the_pairs_walks_only_the_pairs(scene, device):
    """A live count larger than the P pairs given walks the P pairs, as a
    count of P does, into a payload of exactly P slots (the kernel must
    read no key or ray past P and write no slot past it); the used work
    tensor then walks nothing more."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, (ds, st), o, d = scene
    dev = torch.device(device)
    ds = type(ds)(*[t.to(dev) for t in ds])
    to, td = [t.to(dev) for t in _torch(o[:64], d[:64])]
    tmax = torch.full((64,), float("inf"), device=dev)
    tid, _, _ = bin_rays_cuda(ds, st, to, td, tmax)
    live = tid >= 0
    key = (tid * 8)[live].contiguous()
    ray = torch.nonzero(live)[:, 0].to(torch.int32).contiguous()
    p = key.shape[0]

    def fresh():
        best = trav.new_ray_best(tmax, p)
        best.payload.zero_()
        return best

    want = _one_pass(ds, st, to, td, key, ray, tmax, fresh(), 0)
    got = fresh()
    work = torch.tensor([p + 1000, 0], dtype=torch.int32, device=dev)
    walk_pairs_cuda(ds, st, to, td, key, ray, work, tmax, got)
    assert bool(trav.best_t(want)[1].any())
    for f, a, b in zip(trav.RayBest._fields, got, want):
        assert torch.equal(a, b), f
    assert int(work[1]) >= p
    again = trav.RayBest(*[x.clone() for x in got])
    walk_pairs_cuda(ds, st, to, td, key, ray, work, tmax, again)
    for f, a, b in zip(trav.RayBest._fields, again, got):
        assert torch.equal(a, b), f


@pytest.mark.gpu
def test_kernels_equal_their_plain_versions_on_card(scene):
    """Needs a CUDA device and nvcc; `python3 chip_smoke.py` runs the same
    comparisons at full size. Each kernel, as the driver's passes call it,
    against its plain version on the same inputs, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, _, (ds, st), o, d = scene
    dev = torch.device("cuda")
    ds = type(ds)(*[t.to(dev) for t in ds])
    to, td = [t.to(dev) for t in _torch(o, d)]
    tt = torch.full((N_RAYS,), float("inf"), device=dev)
    before = dict(traverse_requeue.launches)

    def same(kernel, plain):
        for a, b in zip(kernel, plain):
            assert torch.equal(a, b)
        return kernel

    def bin_fn(*args):
        return same(bin_rays_cuda(*args), trav.bin_rays(*args))

    def walk(ds, st, o, d, key, ray, work, t_in, best, slot_base,
             any_hit, with_stats):
        plain = trav.RayBest(*[x.clone() for x in best])
        trav.walk_pairs(ds, st, o, d, key, ray, work.clone(), t_in, plain,
                        slot_base, any_hit=any_hit, with_stats=with_stats)
        return same(walk_pairs_cuda(ds, st, o, d, key, ray, work, t_in,
                                    best, slot_base, any_hit=any_hit,
                                    with_stats=with_stats), plain)

    out = traverse_requeue._requeue(bin_fn, walk, trav.intersect_two_level,
                                    ds, st, to, td, tt)
    assert traverse_requeue.launches == {
        "bin_rays": before["bin_rays"] + 1,
        "walk_pairs": before["walk_pairs"] + 2}

    def cpu(res):
        return [type(x)(*[f if f is None else f.cpu() for f in x]) for x in res]

    _compare(cpu(out), cpu(trav.intersect_two_level(ds, st, to, td, tt)),
             False, st.n_tris)
