"""The slice as a whole: tpupt_torch Renderer against the JAX package's, on
the JAX package's tables (carried across with `from_numpy`), same sampler,
same spp.

Per pixel, film `rgb` / `weight` within rtol=1e-4, atol=1e-5 on at least
99.5 % of the pixels (a last-bit difference can flip a Russian-roulette or
lobe choice in the few others), and on those the leaf-visit and path-length
AOVs equal to the same tolerance. The JAX film's single-tap path writes its
masked lanes into the last pixel, so the bottom-right pixel is left out
whenever the batch has masked lanes (here: always, the batch is padded).

The node-visit and prim-test AOVs also count SHADOW rays. Whether a shadow
ray is traced hinges on the sign of a cosine that is zero up to rounding
when the hit lies in the plane of the light it samples (a hit on the
museum's ceiling panel sampling that panel). Such rays carry no radiance
(`rgb` is held above), but each adds one node visit and up to four prim tests
to its pixel. Measured over the four cases below: 16.9 % of the pixels differ
at worst (museum 16x16; 0.9 % on the smoke scene), by at most 1 node visit
and 4 prim tests a sample, and the image totals differ by 0.19 % (node
visits) and 0.26 % (prim tests) at worst. The limits sit just above: equal on
>= 80 % of the pixels, no pixel off by more than one such ray a sample,
totals within 0.5 %."""

import os

import numpy as np
import pytest
import torch

from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.ops import traverse_wide
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

SPP = 2

# the scene of tests/test_smoke_fast.py: area light, sphere, floor
_SMOKE = """
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [12] "integer yresolution" [12]
Sampler "halton" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [2]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "color L" [6 6 6]
  Translate 0 2.2 0
  Shape "trianglemesh" "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 0 0.6  -0.6 0 0.6]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "sphere" "float radius" [0.8]
Shape "trianglemesh" "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def _scenes(name, tmp):
    if name == "museum":
        path = genscene.museum(str(tmp), grid=2, seg=8, rings=4)
        d = os.path.dirname(path)
        return jax_flatten(jax_parse_file(path), d), flatten(parse_file(path), d)
    return jax_flatten(jax_parse_string(_SMOKE)), flatten(parse_string(_SMOKE))


def _with_depth(sc, depth):
    import dataclasses

    return dataclasses.replace(
        sc, integrator=dataclasses.replace(sc.integrator, max_depth=depth))


@pytest.mark.parametrize("name,res,depth", [("museum", 16, 5), ("museum", 32, 3),
                                            ("smoke", 16, 3), ("smoke", 32, 5)])
def test_film_matches_jax_renderer(name, res, depth, tmp_path):
    sj, st_ = _scenes(name, tmp_path)
    sj = _with_depth(jax_with_resolution(sj, res, res), depth)
    st_ = _with_depth(with_resolution(st_, res, res), depth)
    rj = JaxRenderer(sj)
    fj = rj.render(spp=SPP)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st), device="cpu")
    before = traverse_wide.launches
    rt = Renderer(st_, device="cpu", tables=tables)
    ft = rt.render(spp=SPP)
    assert traverse_wide.launches == before  # CPU tensors: the plain version
    assert rt.n_batches == rj.n_batches and rt.batch == rj.batch

    n = res * res
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    assert float(ft.weight.sum()) > 0.9 * SPP * n

    aj, at = np.asarray(fj.aov), ft.aov.numpy()
    good = ok & keep
    for c, what in ((1, "leaf visits"), (3, "path length")):
        np.testing.assert_allclose(at[good, c], aj[good, c], rtol=1e-4,
                                   atol=1e-5, err_msg=what)
    for c, what in ((0, "node visits"), (2, "prim tests")):
        same = np.isclose(at[good, c], aj[good, c], rtol=1e-4, atol=1e-5)
        assert same.mean() >= 0.80, what
        # the AOV is a sum over SPP samples: one flipped shadow ray a sample
        per_ray = 1 if c == 0 else 4
        assert np.abs(at[good, c] - aj[good, c]).max() <= SPP * per_ray + 1e-3, what
        assert abs(at[good, c].sum() - aj[good, c].sum()) \
            <= 0.005 * aj[good, c].sum(), what

    img_t, img_j = rt.image(ft), np.asarray(rj.image(fj))
    assert img_t.shape == (res, res, 3)
    assert abs(img_t.mean() - img_j.reshape(-1, 3)[keep].mean()) < 0.05 * img_j.mean() + 1e-3
    assert set(rt.aovs(ft)) == {"node_visits", "leaf_visits", "prim_tests",
                                "path_length"}


def test_render_is_deterministic_and_continues_a_film(tmp_path):
    _, sc = _scenes("smoke", tmp_path)
    r = Renderer(sc, device="cpu")
    a = r.render(spp=2)
    b = r.render(spp=2)
    np.testing.assert_array_equal(a.rgb.numpy(), b.rgb.numpy())
    c = r.render(spp=1, film=a)
    # out-of-place accumulation: `a` is untouched, `c` holds one more sample
    np.testing.assert_array_equal(a.weight.numpy(), b.weight.numpy())
    assert float(c.weight.sum()) > 1.4 * float(a.weight.sum())


def test_own_upload_renders_like_carried_tables(tmp_path):
    """Renderer(scene) through the port's own upload == through the JAX
    package's tables: the two uploads are array-equal."""
    sj, st_ = _scenes("smoke", tmp_path)
    rj = JaxRenderer(sj)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st), device="cpu")
    a = Renderer(st_, device="cpu", tables=tables).render(spp=1)
    b = Renderer(st_, device="cpu").render(spp=1)
    np.testing.assert_array_equal(a.rgb.numpy(), b.rgb.numpy())
    np.testing.assert_array_equal(a.aov.numpy(), b.aov.numpy())


def test_collect_stats_reaches_the_traversal_and_changes_no_image(
        tmp_path, monkeypatch):
    """`Renderer(collect_stats=...)` defaults to False, as the JAX
    package's does, and hands the flag to the picked traversal's
    `with_stats` on every call. The film is the same with it on and off.
    On the CPU the wrapper runs its plain walker, which always counts, as
    the JAX package's XLA walkers do off the TPU (test_film_matches_jax_
    renderer holds the two AOVs together with both flags at their
    default), so the counter AOVs are the same too."""
    import inspect

    for cls in (Renderer, JaxRenderer):
        flag = inspect.signature(cls).parameters["collect_stats"]
        assert flag.default is False, cls
    _, sc = _scenes("smoke", tmp_path)
    seen = []
    wrapper = traverse_wide.intersect_wide_cuda

    def spy(*args, with_stats=True, **kw):
        seen.append(with_stats)
        return wrapper(*args, with_stats=with_stats, **kw)

    monkeypatch.setattr(traverse_wide, "intersect_wide_cuda", spy)
    films = {}
    for flag in (False, True):
        del seen[:]
        films[flag] = Renderer(sc, device="cpu",
                               collect_stats=flag).render(spp=1)
        assert seen and set(seen) == {flag}
    off, on = films[False], films[True]
    for f in ("rgb", "weight", "aov"):
        np.testing.assert_array_equal(getattr(off, f).numpy(),
                                      getattr(on, f).numpy(), err_msg=f)
    assert float(off.aov[..., 0].sum()) > 0 and float(off.rgb.sum()) > 0


@pytest.mark.parametrize("what", ["integrator", "accelerator"])
def test_renderer_refuses_unported_configurations(what, tmp_path, monkeypatch):
    import dataclasses

    from tpupt_torch.accel import kdbsp

    _, sc = _scenes("smoke", tmp_path)
    if what == "integrator":
        # the other integrators render (tests/test_torch_direct.py,
        # test_torch_bdpt.py, ...) and, since their gradients were ported,
        # differentiate: BDPT's come back finite, the film linear in L
        sc = dataclasses.replace(
            sc, integrator=dataclasses.replace(sc.integrator, name="bdpt"))
        r = Renderer(sc, device="cpu")
        v, g, _ = r.value_and_grad(
            lambda f: f.rgb.sum() + f.splat.sum(), {"light_L": r.ds.light_L})
        assert bool(torch.isfinite(g["light_L"]).all()) and float(v) > 0
        np.testing.assert_allclose(
            float((g["light_L"] * r.ds.light_L).sum()), float(v), rtol=1e-4)
        return
    # the kd / RBSP / BSP accelerators render; what is refused is a tree
    # deeper than the traversal stack
    sc = dataclasses.replace(sc, accelerator_name="kdtree")
    Renderer(sc, device="cpu")
    monkeypatch.setattr(kdbsp, "KD_STACK", 3)
    with pytest.raises(ValueError, match="too deep"):
        Renderer(sc, device="cpu")


@pytest.mark.parametrize("name", ["sobol", "02sequence", "lowdiscrepancy",
                                  "maxmindist", "stratified"])
def test_renderer_takes_every_sampler(name, tmp_path):
    """Each of pbrt-v3's other samplers (the renderer refused them before
    they were ported) renders the smoke scene, with finite pixels, and the
    film's pixel weights are those of the spp."""
    import dataclasses

    _, sc = _scenes("smoke", tmp_path)
    sc = dataclasses.replace(
        sc, sampler=dataclasses.replace(sc.sampler, name=name, spp=4))
    r = Renderer(sc, device="cpu")
    film = r.render(spp=2)
    img = r.image(film)
    assert r.sampler.name == name
    assert np.isfinite(img).all() and img.mean() > 0
    assert float(film.weight.sum()) > 0.9 * 2 * 12 * 12


def test_cli_renders_on_cpu_and_refuses_cuda_without_card(tmp_path):
    import torch

    from tpupt_torch.tools import render
    from tpupt_torch.utils import imageio

    path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
    out = str(tmp_path / "o.pfm")
    assert render.main([path, "--spp", "1", "--resolution", "16x8", "--cpu",
                        "-o", out]) == 0
    img = imageio.read_pfm(out)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            render.main([path, "--spp", "1", "--resolution", "16x8", "-o", out])
