"""The port's command-line tools on the CPU: the thesis's sweep against the
port's `Renderer` and the JAX package's sweep, `--cat` / `--toply` against
the JAX package's text and PLY sidecars, the renderer's one-card flags, and
a render interrupted and resumed from its checkpoint.

The JAX package's sweep renders without `collect_stats` (its CPU walkers
count either way); the port's with it. Its images are 8-bit PNGs: held to
one level. Its counter matrices are written with two decimals: each is
held to 1 % of its total (the node-visit and prim-test ones count shadow
rays, whose tracing can hinge on the sign of a cosine that is zero up to
rounding; test_torch_render), and the path-length and leaf-visit ones equal
on 99 % of the pixels (a last-bit difference of a hit point may flip a
leaf; measured: one pixel of 384)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tpupt.tools import render as jax_render_cli
from tpupt.tools import sweep as jax_sweep
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import render, sweep
from tpupt_torch.utils import imageio

torch.set_num_threads(1)

AOVS = ("node_visits", "leaf_visits", "prim_tests", "path_length")

# the scene of tests/test_smoke_fast.py with the accelerator as a sweep
# parameter ($acc), and a named texture and a floor with normals and uvs
# for the printers
SCENE = """
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [24] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [2]
Accelerator $acc
WorldBegin
Texture "checks" "spectrum" "checkerboard" "float uscale" [4] "float vscale" [4]
AttributeBegin
  AreaLightSource "diffuse" "color L" [6 6 6]
  Translate 0 2.2 0
  Shape "trianglemesh" "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 0 0.6  -0.6 0 0.6]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "sphere" "float radius" [0.8]
AttributeBegin
  Material "matte" "rgb Kd" [0.4 0.5 0.6]
  Shape "trianglemesh" "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
    "normal N" [0 1 0  0 1 0  0 1 0  0 1 0] "float uv" [0 0 1 0 1 1 0 1]
    "integer indices" [0 1 2 2 3 0]
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "sweep.pbrt"
    path.write_text(SCENE)
    return str(path)


@pytest.fixture(scope="module")
def port_sweep(scene_file, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sweep_port"))
    with contextlib.redirect_stdout(io.StringIO()):
        assert sweep.main([scene_file, "--set", "acc=bvh,kdtree", "--cpu",
                           "--outdir", out]) == 0
    return out


def _aov(out, tag, k):
    return np.loadtxt(os.path.join(out, f"{tag}.{k}.txt"))


def test_sweep_writes_every_config_as_the_port_renders_it(port_sweep,
                                                          scene_file):
    recs = json.load(open(os.path.join(port_sweep, "sweep.json")))
    assert [r["tag"] for r in recs] == ["acc-bvh", "acc-kdtree"]
    keys = {"tag", "build_s", "render_s", "spp", "accel", "mean_node_visits",
            "mean_prim_tests"}
    for rec, acc in zip(recs, ("bvh", "kdtree")):
        assert set(rec) == keys and rec["accel"]["kind"] == acc
        assert rec["spp"] == 2 and rec["mean_node_visits"] > 0
        tag = rec["tag"]
        assert os.path.exists(os.path.join(port_sweep, f"{tag}.png"))
        # the same config through the port's Renderer: the same film
        sc = flatten(parse_file(scene_file, subst={"$acc": f'"{acc}"'}),
                     os.path.dirname(scene_file))
        r = Renderer(sc, device="cpu", collect_stats=True)
        film = r.render()
        for k, v in r.aovs(film).items():
            np.testing.assert_allclose(_aov(port_sweep, tag, k), v,
                                       atol=0.0051, err_msg=k)
        assert rec["mean_prim_tests"] == pytest.approx(
            float(r.aovs(film)["prim_tests"].mean()), rel=1e-6)
        np.testing.assert_allclose(
            imageio.read_png(os.path.join(port_sweep, f"{tag}.png")),
            imageio.read_png(_png_of(r.image(film), port_sweep)), atol=1e-6)
    # the kd-tree counts its own visits: the two configs differ there
    assert recs[0]["mean_node_visits"] != recs[1]["mean_node_visits"]


def _png_of(img, d):
    path = os.path.join(d, "_check.png")
    imageio.write_png(path, img)
    return path


def test_sweep_matches_the_jax_package_sweep(port_sweep, scene_file,
                                             tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        assert jax_sweep.main([scene_file, "--set", "acc=bvh", "--cpu",
                               "--outdir", str(tmp_path)]) == 0
    (rj,) = json.load(open(tmp_path / "sweep.json"))
    rt = json.load(open(os.path.join(port_sweep, "sweep.json")))[0]
    assert set(rj) == set(rt) and rj["tag"] == rt["tag"] == "acc-bvh"
    assert rj["accel"] == rt["accel"] and rj["spp"] == rt["spp"]
    for k in AOVS:
        assert os.path.exists(tmp_path / f"acc-bvh.{k}.txt")
        a, b = _aov(str(tmp_path), "acc-bvh", k), _aov(port_sweep, "acc-bvh", k)
        assert abs(b.sum() - a.sum()) <= 0.01 * a.sum(), k
        if k in ("leaf_visits", "path_length"):
            assert np.isclose(b, a, atol=0.0051).mean() >= 0.99, k
    ij = imageio.read_png(str(tmp_path / "acc-bvh.png"))
    it = imageio.read_png(os.path.join(port_sweep, "acc-bvh.png"))
    lev = np.abs(imageio.linear_to_srgb(ij) - imageio.linear_to_srgb(it))
    assert lev.max() <= 1.0 / 255 + 1e-6


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("flag", ["--cat", "--toply"])
def test_cat_and_toply_match_the_jax_package(flag, scene_file, tmp_path,
                                             monkeypatch):
    texts = []
    for name, main in (("port", render.main), ("jax", jax_render_cli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        texts.append(_run(main, [scene_file, flag, "--quiet"]))
    assert texts[0] == texts[1]
    assert 'Shape "sphere"' in texts[0] and "WorldEnd" in texts[0]
    plys = sorted(os.listdir(tmp_path / "port"))
    assert plys == sorted(os.listdir(tmp_path / "jax"))
    if flag == "--toply":
        assert plys == ["mesh_00000.ply", "mesh_00001.ply"]
        assert 'Shape "plymesh"' in texts[0]
        for f in plys:
            assert (tmp_path / "port" / f).read_bytes() == \
                (tmp_path / "jax" / f).read_bytes()
        # the printed scene parses back to the same triangles
        monkeypatch.chdir(tmp_path / "port")
        (tmp_path / "port" / "back.pbrt").write_text(texts[0])
        a = flatten(parse_file(str(tmp_path / "port" / "back.pbrt")),
                    str(tmp_path / "port"))
        b = flatten(parse_string(SCENE.replace("$acc", '"bvh"')))
        assert np.array_equal(a.triangles.p0, b.triangles.p0)
    else:
        assert plys == []


def test_quick_cropwindow_quiet_and_stats(scene_file, tmp_path, capsys):
    scene = str(tmp_path / "s.pbrt")
    with open(scene, "w") as f:
        f.write(open(scene_file).read().replace("$acc", '"bvh"').replace(
            '"integer xresolution" [24] "integer yresolution" [16]',
            '"integer xresolution" [96] "integer yresolution" [64]'))
    full = str(tmp_path / "full.pfm")
    _run(render.main, [scene, "--cpu", "--quick", "--quiet", "-o", full])
    out = str(tmp_path / "q.pfm")
    text = _run(render.main, [scene, "--cpu", "--quick", "--stats",
                              "--cropwindow", "0.25", "0.75", "0.5", "1",
                              "-o", out])
    img, ref = imageio.read_pfm(out), imageio.read_pfm(full)
    assert img.shape == ref.shape == (16, 24, 3)  # a quarter of 96x64
    # the crop window's pixels (rows 8-15, columns 6-17) as the whole film
    # has them, but for its last column: the film there lacks the samples
    # of the pixels to the right whose zero jitter lands one pixel left;
    # beyond the window only the row above and the column left of it get
    # such samples (test_torch_render)
    np.testing.assert_array_equal(img[8:, 6:17], ref[8:, 6:17])
    assert (ref[8:, 6:17].sum(-1) > 0).mean() > 0.25
    img[7:, 5:18] = 0
    assert not img.any()
    assert "Statistics:" in text and "1 spp" in text
    assert "node_visits" in text and "Timings/Rendertime" in text
    # a crop of 12x8 pixels, 1 sample each
    assert "camera rays                     96\n" in text
    capsys.readouterr()
    quiet = _run(render.main, [scene, "--cpu", "--quick", "--quiet",
                               "-o", str(tmp_path / "q2.png")])
    assert quiet == "" and "INFO" not in capsys.readouterr().err
    assert os.path.exists(tmp_path / "q2.png")


def test_logfile_loglevel_and_profile(scene_file, tmp_path):
    scene = str(tmp_path / "s.pbrt")
    with open(scene, "w") as f:
        f.write(open(scene_file).read().replace("$acc", '"bvh"'))
    log = str(tmp_path / "run.log")
    _run(render.main, [scene, "--cpu", "--spp", "1", "--logfile", log,
                       "--loglevel", "debug", "--profile",
                       str(tmp_path / "prof"), "-o",
                       str(tmp_path / "p.png")])
    text = open(log).read()
    assert "parsed and flattened" in text and "profiler: trace written" in text
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]
    from tpupt_torch.utils import logging as tlog

    tlog.set_logfile(str(tmp_path / "other.log"))
    tlog.set_level("error")
    tlog.info("left out")
    tlog.error("kept")
    tlog._state["file"] = None
    tlog.set_level("info")
    assert open(tmp_path / "other.log").read().count("\n") == 1


def test_render_resumable_equals_one_render(scene_file, tmp_path):
    sc = flatten(parse_string(open(scene_file).read().replace(
        "$acc", '"bvh"')))
    ck = str(tmp_path / "film.npz")
    r = Renderer(sc, device="cpu")
    r.render_resumable(spp=2, checkpoint=ck, every=2)   # then "killed"
    film, done = r.load_checkpoint(ck)
    assert done == 2
    resumed = Renderer(sc, device="cpu").render_resumable(
        spp=4, checkpoint=ck, every=2)
    whole = Renderer(sc, device="cpu").render(spp=4)
    for f in ("rgb", "weight", "splat", "aov"):
        assert torch.equal(getattr(resumed, f), getattr(whole, f)), f
    assert Renderer(sc, device="cpu").load_checkpoint(ck)[1] == 4
