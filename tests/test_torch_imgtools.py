"""The port's four host-side tools against the JAX package's, on inputs the
test makes from a seed: `imgtool` (every subcommand on EXR and PFM files:
the same printed lines, return codes and written images; `makesky`
array-equal), `obj2pbrt` and `cyhair2pbrt` (byte-equal files), `bsdftest`
(per material: the same chi-square degrees of freedom and valid share, the
reflectances within 1e-5 relative, chi-square within 1 %), and a scene lit
by a `makesky` sky rendered by both packages at the render-parity
tolerance of test_torch_render.py."""

import os
import struct

import numpy as np
import pytest
import torch

from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.tools import bsdftest as jax_bsdftest
from tpupt.tools import cyhair2pbrt as jax_cyhair2pbrt
from tpupt.tools import imgtool as jax_imgtool
from tpupt.tools import obj2pbrt as jax_obj2pbrt
from tpupt.utils import imageio as jax_imageio
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.tools import bsdftest, cyhair2pbrt, imgtool, obj2pbrt
from tpupt_torch.tools import testscenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BSDF_SAMPLES = 20_000


def test_hosek_data_is_a_byte_copy():
    with open(os.path.join(ROOT, "tpupt/tools/hosek_data.npz"), "rb") as f:
        jax_bytes = f.read()
    with open(imgtool.HOSEK_DATA, "rb") as f:
        assert f.read() == jax_bytes


def _images(tmp_path, ext):
    """Three 12x20 images made from a seed: a, b (a with noise) and a crop
    of a (left half zero)."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.0, 4.0, (12, 20, 3)).astype(np.float32)
    b = (a + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
    crop = a.copy()
    crop[:, :10] = 0.0
    paths = {}
    for name, img in (("a", a), ("b", b), ("crop", crop)):
        paths[name] = str(tmp_path / f"{name}{ext}")
        imgtool.write_image(paths[name], img)
    return paths


def _run_both(capsys, argv_of):
    """(port rc, port output), (JAX rc, JAX output) of one subcommand;
    argv_of(tag) names the outputs of each package apart."""
    rc_t = imgtool.main(argv_of("t"))
    out_t = capsys.readouterr().out
    rc_j = jax_imgtool.main(argv_of("j"))
    out_j = capsys.readouterr().out
    return (rc_t, out_t), (rc_j, out_j)


@pytest.mark.parametrize("ext", [".exr", ".pfm"])
@pytest.mark.parametrize("cmd", ["info", "cat", "convert", "diff",
                                 "assemble"])
def test_imgtool_subcommands_match_jax(cmd, ext, tmp_path, capsys):
    p = _images(tmp_path, ext)
    out = {tag: str(tmp_path / f"out_{tag}{ext}") for tag in "tj"}
    argv_of = {
        "info": lambda tag: ["info", p["a"]],
        "cat": lambda tag: ["cat", p["b"]],
        "convert": lambda tag: ["convert", "--scale", "1.7", "--tonemap",
                                p["a"], out[tag]],
        "diff": lambda tag: ["diff", "--outfile", out[tag], "--tolerance",
                             "1e-3", p["a"], p["b"]],
        "assemble": lambda tag: ["assemble", out[tag], p["crop"], p["a"]],
    }[cmd]
    (rc_t, out_t), (rc_j, out_j) = _run_both(capsys, argv_of)
    assert rc_t == rc_j
    assert out_t == out_j
    assert bool(out_t) == (cmd in ("info", "cat", "diff"))
    if cmd in ("convert", "diff", "assemble"):
        with open(out["t"], "rb") as ft, open(out["j"], "rb") as fj:
            assert ft.read() == fj.read()
    if cmd == "diff":
        assert rc_t == 1  # the noise is above the tolerance
        assert imgtool.main(["diff", p["a"], p["a"]]) == 0


@pytest.mark.parametrize("elevation,turbidity,albedo", [
    (10.0, 3.0, 0.5), (45.0, 7.5, 0.1), (80.0, 1.0, 0.9)])
def test_makesky_is_array_equal(elevation, turbidity, albedo, tmp_path):
    import argparse

    out_j = str(tmp_path / "j.pfm")
    jax_imgtool.cmd_makesky(argparse.Namespace(
        resolution=24, elevation=elevation, turbidity=turbidity,
        albedo=albedo, output=out_j))
    sky = imgtool.make_sky(24, elevation, turbidity, albedo)
    assert sky.shape == (24, 48, 3) and np.isfinite(sky).all()
    np.testing.assert_array_equal(sky, jax_imageio.read_pfm(out_j))
    out_t = str(tmp_path / "t.pfm")
    assert imgtool.main(["makesky", "--resolution", "24", "--elevation",
                         str(elevation), "--turbidity", str(turbidity),
                         "--albedo", str(albedo), out_t]) == 0
    with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
        assert ft.read() == fj.read()
    # the Preetham fallback, where the dataset file is absent
    missing = str(tmp_path / "none.npz")
    np.testing.assert_array_equal(
        imgtool.make_sky(8, elevation, turbidity, albedo, path=missing),
        _jax_preetham(8, elevation, turbidity, albedo, tmp_path, missing))


def _jax_preetham(res, elevation, turbidity, albedo, tmp_path, missing):
    import argparse

    real = jax_imgtool._hosek_config
    try:
        jax_imgtool._hosek_config = lambda *a: None
        out = str(tmp_path / "preetham.pfm")
        jax_imgtool.cmd_makesky(argparse.Namespace(
            resolution=res, elevation=elevation, turbidity=turbidity,
            albedo=albedo, output=out))
    finally:
        jax_imgtool._hosek_config = real
    return jax_imageio.read_pfm(out)


_OBJ = """# a quad, a triangle and a pentagon in two materials
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 1.5 0.25
v 2 0 1
v 2.5 0.5 1
v 2.2 1.1 1.2
vn 0 0 1
vn 0 0.6 0.8
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
f 4/4/2 3/3/2 5/1/2
usemtl shiny
f -3 -2 -1 1 2
"""
_MTL = """newmtl red
Kd 0.8 0.1 0.1
newmtl shiny
Kd 0.2 0.3 0.4
Ks 0.5 0.5 0.5
Ns 40
"""


def test_obj2pbrt_writes_the_jax_file(tmp_path, capsys):
    obj = tmp_path / "scene.obj"
    obj.write_text(_OBJ)
    (tmp_path / "scene.mtl").write_text(_MTL)
    out_t, out_j = str(tmp_path / "t.pbrt"), str(tmp_path / "j.pbrt")
    assert obj2pbrt.main([str(obj), out_t]) == 0
    assert jax_obj2pbrt.main([str(obj), out_j]) == 0
    with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
        text = ft.read()
        assert text == fj.read()
    assert b'"plastic"' in text and b'"matte"' in text
    # the port's own parser reads what it wrote
    flatten(parse_file(out_t))
    assert obj2pbrt.main([str(obj)]) == 1


def _write_hair(path, flags, n_strands=5, seed=3):
    """A .hair file with `flags`' optional arrays, made from a seed."""
    rng = np.random.default_rng(seed)
    segments = rng.integers(1, 6, n_strands).astype("<u2")
    n_points = int((segments.astype(int) + 1).sum())
    if not flags & cyhair2pbrt.HAS_SEGMENTS:
        segments[:] = 4
        n_points = 5 * n_strands
    header = b"HAIR" + struct.pack("<IIII", n_strands, n_points, flags, 4)
    header += struct.pack("<ff", 0.02, 0.5) + struct.pack("<fff", 0.3, 0.2,
                                                          0.1)
    header += b"\0" * (128 - len(header))
    body = b""
    if flags & cyhair2pbrt.HAS_SEGMENTS:
        body += segments.tobytes()
    body += rng.normal(0, 1, (n_points, 3)).astype("<f4").tobytes()
    if flags & cyhair2pbrt.HAS_THICKNESS:
        body += rng.uniform(0.01, 0.05, n_points).astype("<f4").tobytes()
    if flags & cyhair2pbrt.HAS_TRANSPARENCY:
        body += rng.uniform(0, 1, n_points).astype("<f4").tobytes()
    if flags & cyhair2pbrt.HAS_COLOR:
        body += rng.uniform(0, 1, (n_points, 3)).astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(header + body)


@pytest.mark.parametrize("flags,maxstrands", [(31, 0), (2, 0), (19, 3)])
def test_cyhair2pbrt_writes_the_jax_file(flags, maxstrands, tmp_path,
                                         capsys):
    hair = str(tmp_path / "model.hair")
    _write_hair(hair, flags)
    out_t, out_j = str(tmp_path / "t.pbrt"), str(tmp_path / "j.pbrt")
    extra = ["--maxstrands", str(maxstrands)] if maxstrands else []
    assert cyhair2pbrt.main([hair, out_t] + extra) == 0
    assert jax_cyhair2pbrt.main([hair, out_j] + extra) == 0
    with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
        text = ft.read()
        assert text == fj.read()
    assert text.count(b'Shape "curve"') == (maxstrands or 5)
    with open(tmp_path / "bad.hair", "wb") as f:
        f.write(b"NOPE" + b"\0" * 124)
    with pytest.raises(ValueError, match="bad magic"):
        cyhair2pbrt.read_cyhair(str(tmp_path / "bad.hair"))


@pytest.mark.parametrize("material", list(bsdftest.MATERIALS))
def test_bsdftest_matches_jax(material):
    t = bsdftest.run(material, BSDF_SAMPLES, 30.0, 0.2, device="cpu")
    j = jax_bsdftest.run(material, BSDF_SAMPLES, 30.0, 0.2)
    assert t["dof"] == j["dof"] and t["valid_fraction"] == j["valid_fraction"]
    for k in ("rho_sampled", "rho_uniform"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(t["chi2"], j["chi2"], rtol=1e-2)
    # uber's specular transmission (Kt 0.5) is a delta lobe that the
    # uniform estimate cannot see: MISMATCH in both packages
    assert bsdftest.consistent(t) == (material != "uber")


_SKY_SCENE = """
LookAt 0 -4 1.2  0 0 0.6  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
AttributeBegin
  LightSource "infinite" "string mapname" ["sky.exr"] "integer samples" [1]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.55 0.5]
Shape "trianglemesh" "point P" [-30 -30 0  30 -30 0  30 30 0  -30 30 0]
  "integer indices" [0 1 2 2 3 0]
Material "plastic" "rgb Kd" [0.2 0.3 0.6] "float roughness" [0.1]
AttributeBegin
  Translate 0.1 0.2 0.7
  Shape "sphere" "float radius" [0.7]
AttributeEnd
WorldEnd
"""


def test_a_makesky_sky_lights_matching_films(tmp_path):
    """The Hosek sky of `imgtool makesky` as an environment map: the film of
    a small scene under it in both packages, the port on the JAX package's
    tables."""
    assert imgtool.main(["makesky", "--resolution", "32", "--elevation",
                         "35", str(tmp_path / "sky.exr")]) == 0
    path = tmp_path / "sky.pbrt"
    path.write_text(_SKY_SCENE)
    d = str(tmp_path)
    rj = JaxRenderer(jax_flatten(jax_parse_file(str(path)), d))
    fj = rj.render(spp=2)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    rt = Renderer(flatten(parse_file(str(path)), d), device="cpu",
                  tables=tables)
    assert (rt.st.env_w, rt.st.env_h) == (64, 32)
    ft = rt.render(spp=2)
    n = 16 * 16
    keep = np.ones(n, bool)
    keep[-1] = False
    ok = np.ones(n, bool)
    for f in ("rgb", "weight"):
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all()
        ok &= np.isclose(b, a, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[keep].mean() >= 0.995, f"{(~ok[keep]).sum()} pixels differ"
    assert float(ft.rgb.mean()) > 0
