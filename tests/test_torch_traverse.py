"""tpupt_torch wide-BVH traversal (the module that holds CUDA kernel K1)
against the JAX package, on identical tables and rays.

On the CPU `intersect_wide_cuda` runs the kernel's plain version,
`accel.traverse.intersect_wide`. Tolerances, and why:

- `valid`, `prim` and the node / leaf / prim-test counters: exact.
- triangle `t`: <= 4 ulp (measured: 2 to 4 on every scene here).
- barycentrics: 5e-6 absolute. XLA's CPU compiler contracts a*b+c inside the
  compiled while-loop, PyTorch's eager kernels do not, and the edge functions
  x1*y2 - y1*x2 cancel: a barycentric carries the last-bit difference of terms
  as large as (distance to the ray origin / triangle size). Measured worst
  over the four scenes and four modes below: 4.04e-6 absolute (museum), which
  near a zero barycentric is thousands of ulps, so no ulp limit can hold them.
- quadric `t`: 2e-5 relative, for the same reason (b*b - 4ac cancels);
  measured worst 9.4e-6. `p_obj`: 1e-4 absolute, measured worst 9.1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.accel.traverse import intersect_wide as jax_intersect_wide
from tpupt.ops.traverse_pallas import intersect_packets
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import traverse as trav
from tpupt_torch.ops import traverse_wide
from tpupt_torch.ops.traverse_wide import intersect_wide_cuda
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.shapes.triangle import ray_permutation
from tpupt_torch.tools import genscene, testscenes

N_RAYS = 2048
BARY_TOL = 5e-6
QUADRIC_T_RTOL = 2e-5


def _tables(name, tmp):
    if name == "museum":
        path = genscene.museum(str(tmp), grid=2, seg=8, rings=4)
        sc = jax_flatten(jax_parse_file(path), str(tmp))
    else:
        txt = {"random_triangles": lambda: testscenes.random_triangles_pbrt(60, 0),
               "triangles_and_spheres": lambda: testscenes.random_triangles_pbrt(60, 5),
               "quadric_kinds": testscenes.quadric_kinds_pbrt}[name]()
        sc = jax_flatten(jax_parse_string(txt))
    ds_j, st_j = jax_upload(sc)
    ds_t, st_t = from_numpy(*testscenes.tables_as_numpy(ds_j, st_j), device="cpu")
    lo, hi = np.asarray(ds_j.world_lo), np.asarray(ds_j.world_hi)
    return (ds_j, st_j), (ds_t, st_t), (lo, hi)


@pytest.fixture(scope="module", params=["random_triangles",
                                        "triangles_and_spheres",
                                        "quadric_kinds", "museum"])
def scene(request, tmp_path_factory):
    jx, tc, (lo, hi) = _tables(request.param,
                               tmp_path_factory.mktemp(request.param))
    o, d = testscenes.aimed_rays(N_RAYS, 19, lo, hi)
    return request.param, jx, tc, o, d


def _run_both(scene, tmax, any_hit):
    _, (ds_j, st_j), (ds_t, st_t), o, d = scene
    hj, sj = jax_intersect_wide(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(tmax), any_hit=any_hit)
    ht, stt = intersect_wide_cuda(ds_t, st_t, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(tmax),
                                  any_hit=any_hit)
    return (hj, sj), (ht, stt), st_t


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("finite", [False, True], ids=["inf", "finite_tmax"])
def test_hit_records_match_jax(scene, any_hit, finite):
    gen = np.random.default_rng(1)
    tmax = (gen.uniform(2.0, 14.0, N_RAYS).astype(np.float32) if finite
            else np.full(N_RAYS, np.inf, np.float32))
    (hj, sj), (ht, stt), st = _run_both(scene, tmax, any_hit)
    valid = np.asarray(hj.valid)
    assert valid.sum() > (20 if finite else 100)
    np.testing.assert_array_equal(valid, ht.valid.numpy())
    np.testing.assert_array_equal(np.asarray(hj.prim), ht.prim.numpy())
    np.testing.assert_array_equal(np.asarray(sj.node_visits), stt.node_visits.numpy())
    np.testing.assert_array_equal(np.asarray(sj.leaf_visits), stt.leaf_visits.numpy())
    np.testing.assert_array_equal(np.asarray(sj.prim_tests), stt.prim_tests.numpy())
    tri = valid & (np.asarray(hj.prim) < st.n_tris)
    quad = valid & ~tri
    assert testscenes.ulp_distance(hj.t, ht.t.numpy())[tri].max() <= 4
    for name in ("b1", "b2"):
        diff = np.abs(np.asarray(getattr(hj, name)) - getattr(ht, name).numpy())
        assert diff[tri].max() <= BARY_TOL
    if quad.any():
        np.testing.assert_allclose(ht.t.numpy()[quad], np.asarray(hj.t)[quad],
                                   rtol=QUADRIC_T_RTOL)
        np.testing.assert_allclose(ht.p_obj.numpy()[quad],
                                   np.asarray(hj.p_obj)[quad],
                                   rtol=0, atol=1e-4)


def test_matches_brute_force(scene):
    name, _, (ds, st), o, d = scene
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tmax = torch.full((N_RAYS,), float("inf"))
    hw, _ = trav.intersect_wide(ds, st, o, d, tmax)
    hb = trav.intersect_brute(ds, st, o, d, tmax)
    np.testing.assert_array_equal(hw.valid.numpy(), hb.valid.numpy())
    np.testing.assert_array_equal(hw.prim.numpy(), hb.prim.numpy())
    # triangles: same arithmetic per prim, so the winning t is the same
    # float; quadrics: the brute force transforms the ray with the 4x4 w2o
    # through a matrix product, the walker with the packed row term by term
    tri = hb.valid.numpy() & (hb.prim.numpy() < st.n_tris)
    np.testing.assert_array_equal(hw.t.numpy()[tri], hb.t.numpy()[tri])
    quad = hb.valid.numpy() & ~tri
    np.testing.assert_allclose(hw.t.numpy()[quad], hb.t.numpy()[quad], rtol=1e-4)
    occluded, _ = trav.intersect_p(ds, st, o, d, tmax)
    np.testing.assert_array_equal(occluded.numpy(), hb.valid.numpy())


def test_dead_rays_never_enter_the_tree(scene):
    """tmax == 0 marks a dead lane of the wavefront: no node is visited."""
    _, _, (ds, st), o, d = scene
    tmax = np.full(N_RAYS, np.inf, np.float32)
    tmax[::2] = 0.0
    hit, stats = trav.intersect_wide(ds, st, torch.from_numpy(o),
                                     torch.from_numpy(d), torch.from_numpy(tmax))
    dead = torch.from_numpy(tmax == 0.0)
    assert not bool(hit.valid[dead].any())
    assert int(stats.node_visits[dead].sum()) == 0
    assert int(stats.node_visits[~dead].min()) >= 1


def test_against_pallas_kernel_in_interpret_mode(tmp_path):
    """The TPU kernel this port replaces, run as the JAX package's own tests
    run it on the CPU. It skips the zero-edge recompute and bounds t by
    1e-6*det, so rays with an exactly-zero edge function may differ; the
    test identifies them and leaves them out."""
    (ds_j, st_j), (ds_t, st_t), (lo, hi) = _tables("triangles_and_spheres",
                                                   tmp_path)
    o, d = testscenes.aimed_rays(1024, 23, lo, hi)
    tmax = np.full(1024, np.inf, np.float32)
    hp, _ = intersect_packets(ds_j, st_j, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(tmax), interpret=True)
    ht, _ = trav.intersect_wide(ds_t, st_t, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(tmax))
    # zero-edge rays: some triangle has an edge function that is exactly 0
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    perm = ray_permutation(td)
    zero_edge = torch.zeros(1024, dtype=torch.bool)
    from tpupt_torch.shapes.triangle import _permute
    kx, ky, kz, sx, sy, _ = perm
    for tid in range(st_t.n_tris):
        xy = []
        for p in (ds_t.tri_p0[tid], ds_t.tri_p1[tid], ds_t.tri_p2[tid]):
            ax, ay, az = _permute(p - to, kx, ky, kz)
            xy.append((ax - sx * az, ay - sy * az))
        (x0, y0), (x1, y1), (x2, y2) = xy
        e0, e1, e2 = x1 * y2 - y1 * x2, x2 * y0 - y2 * x0, x0 * y1 - y0 * x1
        zero_edge |= (e0 == 0) | (e1 == 0) | (e2 == 0)
    keep = ~zero_edge.numpy()
    assert keep.mean() > 0.99
    np.testing.assert_array_equal(np.asarray(hp.valid)[keep], ht.valid.numpy()[keep])
    np.testing.assert_array_equal(np.asarray(hp.prim)[keep], ht.prim.numpy()[keep])
    m = keep & ht.valid.numpy()
    np.testing.assert_allclose(ht.t.numpy()[m], np.asarray(hp.t)[m], rtol=1e-5)


def test_ray_permutation_ties_take_first_axis():
    d = torch.tensor([[1.0, 1.0, 0.5], [0.5, -2.0, 2.0], [3.0, 3.0, 3.0],
                      [0.0, -1.0, 1.0]])
    kz = ray_permutation(d)[2]
    assert kz.tolist() == [0, 1, 0, 1]
    from tpupt.shapes.triangle import ray_permutation as jax_perm
    assert np.asarray(jax_perm(jnp.asarray(d.numpy()))[2]).tolist() == kz.tolist()


# ------------------------- wrapper contract --------------------------------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    _, (ds, st), (lo, hi) = _tables("random_triangles",
                                    tmp_path_factory.mktemp("small"))
    o, d = testscenes.aimed_rays(64, 3, lo, hi)
    return ds, st, torch.from_numpy(o), torch.from_numpy(d), torch.full((64,), float("inf"))


def test_wrapper_cpu_tensor_runs_plain_version_and_counts_no_launch(small):
    ds, st, o, d, tmax = small
    before = traverse_wide.launches
    hit, stats = intersect_wide_cuda(ds, st, o, d, tmax)
    ref, ref_stats = trav.intersect_wide(ds, st, o, d, tmax)
    assert traverse_wide.launches == before
    np.testing.assert_array_equal(hit.prim.numpy(), ref.prim.numpy())
    np.testing.assert_array_equal(hit.t.numpy(), ref.t.numpy())
    np.testing.assert_array_equal(stats.prim_tests.numpy(),
                                  ref_stats.prim_tests.numpy())


@pytest.mark.parametrize("case", ["dtype", "shape", "tmax_shape",
                                  "noncontiguous", "not_tensor"])
def test_wrapper_refuses_bad_inputs(small, case):
    ds, st, o, d, tmax = small
    if case == "dtype":
        args, err = (o.double(), d, tmax), TypeError
    elif case == "shape":
        args, err = (o[:, :2].contiguous(), d, tmax), ValueError
    elif case == "tmax_shape":
        args, err = (o, d, tmax[:-1]), ValueError
    elif case == "noncontiguous":
        args, err = (o, d.t().contiguous().t(), tmax), ValueError
    else:
        args, err = (o.numpy(), d, tmax), TypeError
    with pytest.raises(err):
        intersect_wide_cuda(ds, st, *args)


def test_renderer_on_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from tpupt_torch.integrators.path import Renderer
    from tpupt_torch.scene.flatten import flatten
    from tpupt_torch.scene.loader import parse_string

    sc = flatten(parse_string(testscenes.random_triangles_pbrt(8, 0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(sc)  # device defaults to "cuda"


@pytest.mark.gpu
def test_kernel_equals_plain_version_on_card(small):
    """Needs a CUDA device and nvcc; `python3 chip_smoke.py` runs the same
    comparison at full size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ds, st, o, d, tmax = small
    dev = torch.device("cuda")
    ds = type(ds)(*[t.to(dev) for t in ds])
    o, d, tmax = o.to(dev), d.to(dev), tmax.to(dev)
    before = traverse_wide.launches
    hk, sk = intersect_wide_cuda(ds, st, o, d, tmax)
    assert traverse_wide.launches == before + 1
    hp, sp = trav.intersect_wide(ds, st, o, d, tmax)
    assert torch.equal(hk.prim, hp.prim) and torch.equal(hk.t, hp.t)
    assert torch.equal(sk.node_visits, sp.node_visits)
