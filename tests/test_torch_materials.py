"""pbrt-v3's other materials in tpupt_torch against the JAX package, on the
CPU: the material rows and tables that flatten and upload build (Disney,
hair, mix, Fourier, subsurface, kdsubsurface), the Fourier .bsdf reader and
the port's writer, the beam-diffusion table, each family's f / pdf / sample,
the mix gather, the subsurface profile weights and exit points, and the
small `tools/testscenes.py` `materials_museum` rendered through the BVH and
through a kd-tree.

Tolerances are those of tests/test_torch_shading.py: rtol 2e-5, atol 1e-6
on floats (last-bit differences of float32 transcendentals between XLA and
ATen), integers and booleans exact; a sampled direction to atol 5e-6 and f /
pdf at it to rtol 2e-4. The Fourier f sums its series in another order
(the 16 knot pairs and the orders side by side) and hair's f / pdf go
through the I0 and log-I0 series and exp / sinh of 1/v: both stay within
the same tolerance. Stated exceptions: the Burley radius (24 bisection
steps) and the tabulated radius to rtol 1e-5, the profile weights to rtol
1e-4 (ratios of exponentials of those radii), the exit points of sss_exit,
which come out of a traversal, to atol 1e-5. Renders as in
tests/test_torch_render.py: film rgb / weight per pixel within rtol 1e-4,
atol 1e-5 on at least 99.5 % of the pixels."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported here, outside any trace: its module constant fails when it is
# first imported inside the JAX package's traced bounce loop
import tpupt.materials.bssrdf as jax_bssrdf
from tpupt.accel import traverse as jax_trav
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import shading_point as jax_shading_point
from tpupt.materials import bsdf as jax_bsdf
from tpupt.materials import bssrdf_table as jax_table
from tpupt.materials import fourier as jax_fourier
from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import traverse as trav
from tpupt_torch.integrators.path import Renderer, shading_point
from tpupt_torch.materials import bsdf as tbsdf
from tpupt_torch.materials import bssrdf, bssrdf_table, fourier, hair
from tpupt_torch.ops import traverse_kdbsp, traverse_wide
from tpupt_torch.scene.device import from_numpy, host_tables
from tpupt_torch.scene.flatten import (MAT_DISNEY, MAT_FOURIER, MAT_HAIR,
                                       MAT_KDSUBSURFACE, MAT_MIX,
                                       MAT_SUBSURFACE, flatten,
                                       with_resolution)
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.tools import genscene, testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-6
N = 512
# the small materials museum: 9 statues, so every family is in it
SMALL = dict(n_hairs=8, grid=3, seg=8, rings=4)


def _close(a, b, what="", rtol=RTOL, atol=ATOL):
    a = np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert np.isfinite(b).all(), what
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)


_CACHE = {}


def _museum(tmp_path_factory):
    """(path, jax FlatScene, port FlatScene) of the small materials museum,
    written once per module."""
    if "m" not in _CACHE:
        d = str(tmp_path_factory.mktemp("materials_museum"))
        path = testscenes.materials_museum(d, **SMALL)
        _CACHE["m"] = (path, jax_flatten(jax_parse_file(path), d),
                       flatten(parse_file(path), d))
    return _CACHE["m"]


def _tables(tmp_path_factory):
    """The JAX package's upload of the small museum and the port's tables
    carried across from it."""
    if "t" not in _CACHE:
        _, sj, _ = _museum(tmp_path_factory)
        dj, stj = jax_upload(sj, light_strategy="spatial")
        _CACHE["t"] = (dj, stj, *from_numpy(
            *testscenes.tables_as_numpy(dj, stj), device="cpu"))
    return _CACHE["t"]


def test_flatten_and_upload_are_array_equal(tmp_path_factory):
    """Every material row (type, kd ... extra), the Fourier table, the
    BSSRDF rows `sss_pack` and the statics that name the families: the
    same in both packages' flatten and upload, and `from_numpy` carries
    them across unchanged."""
    _, sj, sp = _museum(tmp_path_factory)
    for f in dataclasses.fields(sj.materials):
        a, b = (np.asarray(getattr(s.materials, f.name)) for s in (sj, sp))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    assert set(np.asarray(sp.materials.type).tolist()) >= {
        MAT_DISNEY, MAT_HAIR, MAT_MIX, MAT_SUBSURFACE, MAT_KDSUBSURFACE,
        MAT_FOURIER}
    for k, v in sj.fourier_table.items():
        np.testing.assert_array_equal(sp.fourier_table[k], v, err_msg=k)
    dj, stj, dt, stt = _tables(tmp_path_factory)
    fields, st = host_tables(sp, light_strategy="spatial")
    for k in ("mat_type", "mat_kd", "mat_extra", "mat_eta", "sss_pack",
              "four_mu", "four_a", "four_m", "four_aoff", "four_cdf",
              "tri_mat", "tri_uv0", "light_L"):
        a, b = np.asarray(getattr(dj, k)), np.asarray(fields[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
        assert np.asarray(getattr(dt, k)).tobytes() == a.tobytes(), k
    for k in ("mat_features", "fourier", "has_bssrdf_table"):
        assert getattr(st, k) == getattr(stj, k) == getattr(stt, k), k
    assert st.mat_features == {"disney", "hair", "mix", "sss", "fourier"}
    assert st.mix_features == stt.mix_features == frozenset()
    assert st.fourier["n_channels"] == 3 and st.fourier["m_max"] > 1


def test_beam_diffusion_table_and_subsurface_from_diffuse():
    for eta in (1.33, 1.5):
        a = bssrdf_table.compute_beam_diffusion_table(eta)
        b = jax_table.compute_beam_diffusion_table(eta)
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
        kd = np.array([0.1, 0.5, 0.9])
        for x, y in zip(bssrdf_table.subsurface_from_diffuse(a, kd, 0.3),
                        jax_table.subsurface_from_diffuse(b, kd, 0.3)):
            np.testing.assert_array_equal(x, y)


def test_bsdf_files_written_by_the_port_read_the_same(tmp_path):
    tbl = testscenes.fourier_test_table()
    path = str(tmp_path / "t.bsdf")
    fourier.write_bsdf_file(path, tbl)
    for reader in (fourier.read_bsdf_file, jax_fourier.read_bsdf_file):
        got = reader(path)
        for k, v in tbl.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert len(set(tbl["m"][tbl["m"] > 0].tolist())) > 2   # several orders


_FAMILIES = ["disney_metal", "disney_spectrans", "disney_thin", "mix",
             "fourier", "subsurface", "kdsubsurface", "hair"]
# the row of each family in the small museum: statue k takes
# MATERIALS_MUSEUM_MATERIALS[k] (the mix's two children come right after it)
_FAMILY_TYPE = {"disney_metal": (MAT_DISNEY, 0), "disney_spectrans":
                (MAT_DISNEY, 1), "disney_thin": (MAT_DISNEY, 2),
                "mix": (MAT_MIX, 0), "fourier": (MAT_FOURIER, 0),
                "subsurface": (MAT_SUBSURFACE, 0),
                "kdsubsurface": (MAT_KDSUBSURFACE, 0), "hair": (MAT_HAIR, 0)}


def _unit(gen, n):
    v = gen.normal(0, 1, (n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("family", _FAMILIES)
def test_material_family_eval_and_sample(family, tmp_path_factory):
    """gather_mat_params (with the mix children and the Fourier table),
    eval_pdf and sample of one family's row, on random directions, lobe
    samples and uv (h = the hair fiber offset), against the JAX
    package's."""
    dj, stj, dt, stt = _tables(tmp_path_factory)
    tid, k = _FAMILY_TYPE[family]
    mid = int(np.nonzero(np.asarray(dj.mat_type) == tid)[0][k])
    gen = np.random.default_rng(_FAMILIES.index(family))
    wo = _unit(gen, N)
    wo[: N // 8, 2] *= 0.02     # grazing directions
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi = _unit(gen, N)
    u = gen.random((3, N)).astype(np.float32)
    uv = gen.random((N, 2)).astype(np.float32)
    mat = np.full(N, mid, np.int32)
    # the family's own feature: the other families' lobes are selected
    # only on their own rows (the whole set runs in the render tests)
    feats = frozenset({family.split("_")[0].replace("kd", "").replace(
        "subsurface", "sss")})
    mj = jax_bsdf.gather_mat_params(
        dj, jnp.asarray(mat), uv=jnp.asarray(uv), has_mix=True,
        fourier_meta=stj.fourier)
    mt = tbsdf.gather_mat_params(dt, torch.from_numpy(mat),
                                 uv=torch.from_numpy(uv), has_mix=True,
                                 fourier_meta=stt.fourier)
    for m_j, m_t, tag in ((mj, mt, ""), (mj.mix_a, mt.mix_a, "mix_a."),
                          (mj.mix_b, mt.mix_b, "mix_b.")):
        for f in ("type", "kd", "ks", "eta", "k", "alpha_x", "alpha_y",
                  "extra", "rough", "h"):
            _close(getattr(m_j, f), getattr(m_t, f), f"MatParams.{tag}{f}")
    if family == "mix":
        assert int(mt.mix_a.type[0]) != int(mt.mix_b.type[0])
    rt = RTOL
    fj, pj = jax_bsdf.eval_pdf(mj, jnp.asarray(wo), jnp.asarray(wi), feats)
    ft, pt = tbsdf.eval_pdf(mt, torch.from_numpy(wo), torch.from_numpy(wi),
                            feats, stt.mix_features)
    _close(fj, ft, "eval f", rtol=rt)
    _close(pj, pt, "eval pdf", rtol=rt)
    bj = jax_bsdf.sample(mj, jnp.asarray(wo), *(jnp.asarray(x) for x in u),
                         feats)
    bt = tbsdf.sample(mt, torch.from_numpy(wo),
                      *(torch.from_numpy(x) for x in u), feats,
                      stt.mix_features)
    _close(bj.specular, bt.specular, "specular")
    _close(bj.wi, bt.wi, "sample wi", atol=5e-6)
    _close(bj.pdf, bt.pdf, "sample pdf", rtol=2e-4)
    _close(bj.eta_scale, bt.eta_scale, "eta_scale")
    _close(bj.f, bt.f, "sample f", rtol=2e-4)
    assert float(ft.abs().max()) > 0.0 or family.endswith("subsurface")
    assert float(bt.pdf.max()) > 0.0


def test_hair_and_fourier_sampling_agree_with_their_pdfs(tmp_path_factory):
    """The port's own check of the two tabulated / series lobes: the
    directions hair_sample and fourier_sample draw are where their pdfs put
    the mass (the pdf at the sampled directions is positive, and a
    uniform-sphere estimate of each pdf's integral is near 1)."""
    _, _, dt, stt = _tables(tmp_path_factory)
    gen = np.random.default_rng(5)
    n = 20000
    wo = torch.from_numpy(np.tile(_unit(gen, 1), (n, 1)))
    wi = torch.from_numpy(_unit(gen, n))
    uv = torch.from_numpy(gen.random((n, 2)).astype(np.float32))
    for tid in (MAT_HAIR, MAT_FOURIER):
        mid = int(np.nonzero(dt.mat_type.numpy() == tid)[0][0])
        mp = tbsdf.gather_mat_params(dt, torch.full((n,), mid), uv=uv,
                                     fourier_meta=stt.fourier)
        if tid == MAT_HAIR:
            _, pdf = hair.hair_f_pdf(mp, wo, wi)
        else:
            pdf = fourier.fourier_pdf(mp.fourier, wo, wi)
        est = float(pdf.mean()) * 4.0 * np.pi
        assert 0.8 < est < 1.2, (tid, est)


def test_burley_and_tabulated_profile_weights(tmp_path_factory):
    """The Burley profile, cdf, sampled radius and Fresnel moment, and the
    tabulated (sss_pack) radius and channel-MIS weight, on random lanes of
    both subsurface rows."""
    dj, _, dt, _ = _tables(tmp_path_factory)
    gen = np.random.default_rng(7)
    r = gen.uniform(0.0, 3.0, N).astype(np.float32)
    d = gen.uniform(0.05, 1.0, N).astype(np.float32)
    u = gen.random(N).astype(np.float32)
    eta = gen.uniform(1.1, 1.6, N).astype(np.float32)
    tr = [torch.from_numpy(x) for x in (r, d, u, eta)]
    _close(jax_bssrdf.burley_profile(jnp.asarray(r), jnp.asarray(d)),
           bssrdf.burley_profile(tr[0], tr[1]), "burley profile")
    _close(jax_bssrdf.burley_cdf(jnp.asarray(r), jnp.asarray(d)),
           bssrdf.burley_cdf(tr[0], tr[1]), "burley cdf")
    _close(jax_bssrdf.burley_sample_r(jnp.asarray(u), jnp.asarray(d)),
           bssrdf.burley_sample_r(tr[2], tr[1]), "burley r", rtol=1e-5)
    _close(jax_bssrdf.fresnel_moment1(1.0 / jnp.asarray(eta)),
           bssrdf.fresnel_moment1(1.0 / tr[3]), "fresnel moment 1")
    ids = np.nonzero(np.isin(np.asarray(dj.mat_type),
                             [MAT_SUBSURFACE, MAT_KDSUBSURFACE]))[0]
    mat = ids[gen.integers(0, len(ids), N)].astype(np.int32)
    ch = gen.integers(0, 3, N).astype(np.int32)
    rj, wj = jax_bssrdf.tabulated_sample_weight(
        dj, jnp.asarray(mat), jnp.asarray(ch), jnp.asarray(u), None)
    rt_, wt = bssrdf.tabulated_sample_weight(
        dt, torch.from_numpy(mat), torch.from_numpy(ch), tr[2])
    _close(rj, rt_, "tabulated r", rtol=1e-5)
    _close(wj, wt, "tabulated weight", rtol=1e-4)


_SLAB = """
LookAt 0 0 3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "distant" "rgb L" [2 2 2] "point from" [0 0 5] "point to" [0 0 0]
Material "subsurface" "rgb sigma_a" [0.05 0.1 0.2] "rgb sigma_prime_s" [3 4 5]
Shape "trianglemesh" "point P" [-2 -2 0  2 -2 0  2 2 0  -2 2 0] "integer indices" [0 1 2 0 2 3]
Shape "trianglemesh" "point P" [-2 -2 -0.4  -2 2 -0.4  2 2 -0.4  2 -2 -0.4] "integer indices" [0 1 2 0 2 3]
WorldEnd
"""


def test_subsurface_exit_points_on_a_slab():
    """sss_exit on a two-quad slab: hits on its top face, a random half of
    them entering; the exit points (found by the probe ray through each
    package's BVH walker), normals, profile weights, normalisation and
    acceptance mask against the JAX package's."""
    sj = jax_flatten(jax_parse_string(_SLAB))
    dj, stj = jax_upload(sj)
    dt, stt = from_numpy(*testscenes.tables_as_numpy(dj, stj), device="cpu")
    assert stt.has_bssrdf_table and stt.mat_features == {"sss"}
    gen = np.random.default_rng(11)
    o = np.concatenate([gen.uniform(-1.5, 1.5, (N, 2)), np.full((N, 1), 2.0)],
                       1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (N, 1))
    tmax = np.full(N, np.inf, np.float32)
    hj, _ = jax_trav.intersect_wide(dj, stj, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tmax))
    ht, _ = trav.intersect_wide(dt, stt, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(tmax))
    assert bool(ht.valid.all())
    spj = jax_shading_point(dj, stj, hj, jnp.asarray(o), jnp.asarray(d))
    spt = shading_point(dt, stt, ht, torch.from_numpy(o), torch.from_numpy(d))
    mj = jax_bsdf.gather_mat_params(dj, spj.mat, uv=spj.uv)
    mt = tbsdf.gather_mat_params(dt, spt.mat, uv=spt.uv)
    entered = gen.random(N) < 0.5
    key = gen.integers(0, 2**32, N, dtype=np.int64)

    def jax_isect(ds, st, o_, d_, tmax_):
        return jax_trav.intersect_wide(ds, st, o_, d_, tmax_)

    out_j = jax_bssrdf.sss_exit(dj, stj, jax_isect, mj, spj,
                                jnp.asarray(entered),
                                jnp.asarray(key.astype(np.uint32)))
    out_t = bssrdf.sss_exit(
        dt, stt, mt, spt, torch.from_numpy(entered), torch.from_numpy(key),
        lambda o_, d_, t_: trav.intersect_wide(dt, stt, o_, d_, t_)[0],
        lambda h_, o_, d_: shading_point(dt, stt, h_, o_, d_))
    for name, a, b, atol in zip(("p_exit", "n_exit", "w_profile", "c_norm",
                                 "ok"), out_j, out_t,
                                (1e-5, 1e-5, ATOL, ATOL, None)):
        _close(a, b, name, rtol=1e-4 if name == "w_profile" else RTOL,
               atol=atol or 0)
    ok = out_t[4].numpy()
    assert ok.sum() > 0.3 * entered.sum() and not ok[~entered].any()
    moved = np.linalg.norm(out_t[0].numpy() - spt.p.numpy(), axis=-1)
    assert moved[ok].mean() > 1e-3


def _film_agrees(fj, ft, n):
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"


@pytest.mark.parametrize("accel", ["bvh", "kdtree"])
def test_materials_museum_render_matches_jax(accel, tmp_path_factory):
    """16x16, 2 spp of the small materials museum (three Disney statues, a
    mix, a Fourier, a subsurface and a kdsubsurface statue, a hair tuft
    of curves, the sobol sampler) through the BVH and through a kd-tree:
    the port's film per pixel against the JAX package's; the subsurface
    lanes add a probe and an exit shadow ray a vertex."""
    _, sj, sp = _museum(tmp_path_factory)
    sj = jax_with_resolution(sj, 16, 16)
    sp = with_resolution(sp, 16, 16)
    if accel != "bvh":
        sj = dataclasses.replace(sj, accelerator_name=accel)
        sp = dataclasses.replace(sp, accelerator_name=accel)
    rj = JaxRenderer(sj)
    fj = rj.render(spp=2)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    before = (traverse_wide.launches, traverse_kdbsp.launches)
    rt = Renderer(sp, device="cpu", tables=tables)
    calls = []
    isect = rt._isect
    rt._isect = lambda *a, **k: calls.append(1) or isect(*a, **k)
    ft = rt.render(spp=2)
    assert (traverse_wide.launches, traverse_kdbsp.launches) == before
    assert rt.accel_stats["kind"] == accel
    assert sp.sampler.name == "sobol"
    assert len(calls) == 4 * (sp.integrator.max_depth + 1) * 2
    _film_agrees(fj, ft, 16 * 16)
    img = rt.image(ft)
    assert img.mean() > 0.005 and np.ptp(img) > 0.05


def test_scenes_without_the_families_run_none_of_their_code(monkeypatch,
                                                           tmp_path):
    """A scene without Disney, hair, mix, Fourier or subsurface rows
    computes none of them: with every entry point of those families made to
    raise, the museum renders, and it makes two traversal calls a vertex."""
    def boom(*a, **k):
        raise AssertionError("a family absent from the scene was computed")

    for mod, name in ((tbsdf, "_disney_f"), (tbsdf, "_disney_pdf"),
                      (tbsdf, "_disney_lobe_weights"),
                      (tbsdf, "hair_f_pdf"), (tbsdf, "hair_sample"),
                      (tbsdf, "fourier_f"), (tbsdf, "fourier_pdf"),
                      (tbsdf, "fourier_sample")):
        monkeypatch.setattr(mod, name, boom)
    import tpupt_torch.integrators.path as tpath
    monkeypatch.setattr(tpath, "sss_exit", boom)
    path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
    sc = with_resolution(flatten(parse_file(path), str(tmp_path)), 16, 16)
    r = Renderer(sc, device="cpu")
    assert r.st.mat_features == frozenset() and not r.st.has_bssrdf_table
    calls = []
    isect = r._isect
    r._isect = lambda *a, **k: calls.append(1) or isect(*a, **k)
    assert r.image(r.render(spp=1)).mean() > 0
    assert len(calls) == 2 * (sc.integrator.max_depth + 1)
