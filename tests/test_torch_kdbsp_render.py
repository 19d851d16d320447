"""The kd / RBSP / BSP slice as a whole: tpupt_torch's Renderer with
`Accelerator "kdtree"` / `"rbsp"` against the JAX package's (on the CPU both
walk the tree with their per-ray walker `intersect_kdbsp`), same scene, same
sampler, same spp, at 32x32.

Bounds are those of tests/test_torch_render.py for the BVH path: per pixel,
film `rgb` / `weight` within rtol=1e-4, atol=1e-5 on at least 99.5 % of the
pixels (a last-bit difference can flip a Russian-roulette or lobe choice in
the few others; the bottom-right pixel, where the JAX film parks its masked
lanes, is left out), path length equal on those. The node / leaf / prim-test
AOVs are held as that file holds the two that count shadow rays: equal on
>= 80 % of the pixels and totals within 0.5 %. Here all three can move: a
shadow ray of a light sample coplanar with its hit is traced by one package
and not by the other (ROADMAP section 3), and a kd-tree walk that ends on a
cell boundary may visit one cell more or less (tests/
test_torch_kdbsp_traverse.py). A per-pixel cap as for the BVH does not hold:
one extra cell of a kd walk costs several node visits.

Port against port: the `kdtree` render equals the `bvh` render of the same
scene to the same image bound (same hits, same samples; only the traversal
counters differ)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.flatten import with_resolution as jax_with_resolution
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.accel import kdbsp
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.ops import traverse_kdbsp, traverse_wide
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten, with_resolution
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.scene.params import ParamSet
from tpupt_torch.tools import genscene, testscenes

from test_torch_render import _SMOKE

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

RES = 32
DEPTH = 5


def _scene_pair(name, tmp):
    if name == "museum":
        path = genscene.museum(str(tmp), grid=2, seg=8, rings=4)
        d = os.path.dirname(path)
        sj, st = jax_flatten(jax_parse_file(path), d), flatten(parse_file(path), d)
    else:
        sj, st = jax_flatten(jax_parse_string(_SMOKE)), flatten(parse_string(_SMOKE))
    return (_sized(jax_with_resolution(sj, RES, RES)),
            _sized(with_resolution(st, RES, RES)))


def _sized(sc):
    return dataclasses.replace(
        sc, integrator=dataclasses.replace(sc.integrator, max_depth=DEPTH))


def _with_accel(sc, accel, ndirs):
    ps = type(sc.accelerator_params)() if sc.accelerator_params is not None \
        else ParamSet()
    if ndirs:
        ps.add("integer nbDirections", [ndirs])
    return dataclasses.replace(sc, accelerator_name=accel,
                               accelerator_params=ps)


@pytest.mark.parametrize("accel,ndirs", [("kdtree", None), ("rbsp", 7)])
@pytest.mark.parametrize("name,spp", [("smoke", 2), ("museum", 1)])
def test_film_matches_jax_renderer(name, spp, accel, ndirs, tmp_path):
    sj, st_ = _scene_pair(name, tmp_path)
    sj, st_ = _with_accel(sj, accel, ndirs), _with_accel(st_, accel, ndirs)
    rj = JaxRenderer(sj)
    fj = rj.render(spp=spp)
    before = traverse_kdbsp.launches
    if accel == "kdtree":
        # the JAX package's tables, tree included, carried across
        tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                            device="cpu")
        assert tables[1].alt_tree_depth == rj.accel_stats["tree_depth"]
        rt = Renderer(st_, device="cpu", tables=tables)
    else:
        rt = Renderer(st_, device="cpu")   # the port's own upload and build
    for k in ("kind", "n_nodes", "max_leaf", "n_leaves", "tree_depth"):
        assert rt.accel_stats[k] == rj.accel_stats[k], k
    ft = rt.render(spp=spp)
    assert traverse_kdbsp.launches == before  # CPU tensors: the plain version

    n = RES * RES
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    assert float(ft.weight.sum()) > 0.9 * spp * n

    aj, at = np.asarray(fj.aov), ft.aov.numpy()
    good = ok & keep
    np.testing.assert_allclose(at[good, 3], aj[good, 3], rtol=1e-4, atol=1e-5,
                               err_msg="path length")
    for c, what in ((0, "node visits"), (1, "leaf visits"), (2, "prim tests")):
        same = np.isclose(at[good, c], aj[good, c], rtol=1e-4, atol=1e-5)
        assert same.mean() >= 0.80, (what, same.mean())
        assert abs(at[good, c].sum() - aj[good, c].sum()) \
            <= 0.005 * aj[good, c].sum(), what
        assert at[good, c].sum() > 0, what


@pytest.mark.parametrize("name", ["smoke", "museum"])
def test_kdtree_image_equals_bvh_image(name, tmp_path):
    _, sc = _scene_pair(name, tmp_path)
    rb = Renderer(sc, device="cpu")
    rk = Renderer(_with_accel(sc, "kdtree", None), device="cpu")
    assert rb.accel_stats["kind"] == "bvh" and rk.accel_stats["kind"] == "kdtree"
    fb, fk = rb.render(spp=1), rk.render(spp=1)
    ok = np.isclose(fk.rgb.numpy(), fb.rgb.numpy(), rtol=1e-4, atol=1e-5)
    assert ok.reshape(RES * RES, -1).all(-1).mean() >= 0.995
    np.testing.assert_array_equal(fk.weight.numpy(), fb.weight.numpy())
    # another tree, other counters: the thesis's comparison
    ab, ak = rb.aovs(fb), rk.aovs(fk)
    assert ak["node_visits"].sum() != ab["node_visits"].sum()
    np.testing.assert_allclose(ak["path_length"], ab["path_length"])


def test_scene_file_selects_the_accelerator():
    """`Accelerator "rbsp" "integer nbDirections" [9]` in the scene text."""
    txt = _SMOKE.replace('Integrator "path"',
                         'Accelerator "rbsp" "integer nbDirections" [9]\n'
                         'Integrator "path"')
    r = Renderer(with_resolution(flatten(parse_string(txt)), 8, 8), device="cpu")
    assert r.accel_stats["kind"] == "rbsp" and r.accel_dirs.shape == (9, 3)
    assert r.st.alt_tree_depth == r.accel_stats["tree_depth"] > 1
    assert r.ds.alt_nodes.shape == (r.accel_stats["n_nodes"], 8)
    img = r.image(r.render(spp=1))
    assert np.isfinite(img).all() and img.mean() > 0


def test_a_tree_deeper_than_the_stack_is_refused(monkeypatch, tmp_path):
    _, sc = _scene_pair("smoke", tmp_path)
    monkeypatch.setattr(kdbsp, "KD_STACK", 4)
    with pytest.raises(ValueError, match="too deep for the traversal stack"):
        Renderer(_with_accel(sc, "kdtree", None), device="cpu")


def test_cuda_default_needs_a_card_not_a_later_pr(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this refusal is for a machine without a CUDA device")
    _, sc = _scene_pair("smoke", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Renderer(_with_accel(sc, "kdtree", None))   # device defaults to "cuda"


def test_cli_renders_with_accelerator_and_writes_the_tree(tmp_path):
    from tpupt_torch.tools import render
    from tpupt_torch.utils import imageio

    path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
    out = str(tmp_path / "o.pfm")
    before = (traverse_wide.launches, traverse_kdbsp.launches)
    assert render.main([path, "--spp", "1", "--resolution", "16x8", "--cpu",
                        "--accelerator", "kdtree", "--dumptree",
                        "--writestats", "-o", out]) == 0
    assert (traverse_wide.launches, traverse_kdbsp.launches) == before
    img = imageio.read_pfm(out)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    tree = (tmp_path / "o-tree.txt").read_text().splitlines()
    assert tree[0] == "3" and int(tree[4]) == len(tree) - 5
    assert sum(ln.startswith("L") for ln in tree) > 10
    depths = (tmp_path / "o-kdNodeDepths.txt").read_text().split()
    assert depths[:2] == ["0", "1"]            # one kd node at depth 0
    assert (tmp_path / "o-leafNodeDepths.txt").exists()
    assert not (tmp_path / "o-bspNodeDepths.txt").read_text()
    nodes = np.loadtxt(tmp_path / "o.node_visits.txt")
    assert nodes.shape == (8, 16) and nodes.sum() > 0
    # the default accelerator writes no tree
    out2 = str(tmp_path / "b.pfm")
    assert render.main([path, "--spp", "1", "--resolution", "16x8", "--cpu",
                        "--dumptree", "-o", out2]) == 0
    assert not (tmp_path / "b-tree.txt").exists()
