"""The port's textures and sampling distributions against the JAX
package's, on the CPU: the flattened texture, material and light-map tables
of a scene that uses all fourteen texture classes (image maps and light maps
written as PFM and EXR, a ptex file written by the port's own writer), array
equal; `eval_texture` per texture type on the same seeded lanes; and
`Distribution1D` / `Distribution2D` on the same tables.

Tolerances. `eval_texture`: 1e-6 absolute, tightened from the 1e-5 first
asked for after measuring. Both packages compute the same float32
expressions in the same order, eagerly (no fused multiply-adds), and every
hash is the same u32 arithmetic; what can differ is the last bit of
transcendentals (sin, log2) and of 3-term dot products (the 3D
checkerboard's einsum). Measured on these lanes: 0 on every type but the
image map (1.8e-7: a log2 of the footprint) and marble (6e-8: a sin).
Lanes keep uv within +-1e3 and p within +-50: a float-to-int32 cast of a
larger value is implementation-defined in both packages. Distributions:
sample offsets equal, continuous samples and pdfs within 1e-6 relative; the
host-built tables within 1e-6 (numpy's float32 cumsum against XLA's)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.core.sampling import Distribution1D as JaxD1
from tpupt.core.sampling import Distribution2D as JaxD2
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.textures import ptex as jax_ptex
from tpupt.textures import textures as jax_tex
from tpupt_torch.core.sampling import (Distribution1D, Distribution2D,
                                       build_distribution1d,
                                       build_distribution2d)
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file
from tpupt_torch.textures import ptex
from tpupt_torch.textures import textures as tex
from tpupt_torch.utils import imageio

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

TEX_ATOL = 1e-6
N_LANES = 4096

# one texture of every class, a material for each, and the light maps
ALL_CLASSES = """
LookAt 0 -4 2  0 0 0.5  0 0 1
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
Integrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "infinite" "string mapname" ["env.exr"] "rgb L" [0.8 0.8 0.8]
LightSource "infinite" "rgb L" [0.05 0.05 0.05]
AttributeBegin
  Translate 1 -1 3
  LightSource "goniometric" "rgb I" [6 6 6] "string mapname" ["gonio.pfm"]
AttributeEnd
AttributeBegin
  Translate -1 -1 3
  Rotate 180 1 0 0
  LightSource "projection" "rgb I" [8 8 8] "float fov" [60]
    "string mapname" ["proj.exr"]
AttributeEnd
Texture "const" "spectrum" "constant" "rgb value" [0.3 0.5 0.7]
Texture "scale" "spectrum" "scale" "texture tex1" "const" "rgb tex2" [0.9 0.8 0.7]
Texture "mix" "spectrum" "mix" "rgb tex1" [0.1 0.2 0.3] "rgb tex2" [0.7 0.6 0.5]
  "float amount" [0.3]
Texture "check" "spectrum" "checkerboard" "float uscale" [6] "float vscale" [6]
  "rgb tex1" [0.8 0.8 0.8] "rgb tex2" [0.1 0.1 0.1]
AttributeBegin
  Scale 3 3 3
  Texture "check3d" "spectrum" "checkerboard" "integer dimension" [3]
    "rgb tex1" [0.9 0.2 0.2] "rgb tex2" [0.2 0.2 0.9]
AttributeEnd
Texture "uv" "spectrum" "uv" "float uscale" [2] "float vscale" [3]
Texture "img_pfm" "spectrum" "imagemap" "string filename" ["img.pfm"]
  "float uscale" [3] "float vscale" [2]
Texture "img_exr" "spectrum" "imagemap" "string filename" ["img.exr"]
  "float scale" [0.8]
Texture "fbm" "spectrum" "fbm"
Texture "wrinkled" "spectrum" "wrinkled"
Texture "marble" "spectrum" "marble" "float scale" [2]
Texture "windy" "spectrum" "windy"
Texture "dots" "spectrum" "dots" "rgb tex1" [0.9 0.1 0.1] "rgb tex2" [0.2 0.2 0.2]
  "float uscale" [5] "float vscale" [5]
Texture "bilerp" "spectrum" "bilerp" "rgb tex1" [0.1 0.5 0.9] "rgb tex2" [0.9 0.5 0.1]
Texture "ptex" "spectrum" "ptex" "string filename" ["faces.ptx"]
Material "plastic" "texture Kd" "img_pfm" "texture Ks" "marble"
Shape "trianglemesh" "point P" [-3 -3 0  3 -3 0  3 3 0  -3 3 0]
  "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
{materials}
Material "matte" "texture Kd" "ptex"
Shape "trianglemesh" "point P" [-2 2.5 0  2 2.5 0  2 2.5 3  -2 2.5 3]
  "integer indices" [0 1 2 0 2 3] "float uv" [0 0 1 0 1 1 0 1]
  "integer faceIndices" [0 1]
WorldEnd
"""
# the rest of the classes, one small quad each on a row above the floor
_OTHERS = ("const", "scale", "mix", "check", "check3d", "uv", "img_exr",
           "fbm", "wrinkled", "windy", "dots", "bilerp")


def _others():
    out = []
    for i, name in enumerate(_OTHERS):
        x = -2.6 + 0.45 * i
        out.append(f'Material "matte" "texture Kd" "{name}"\n'
                   f'Shape "trianglemesh" "point P" [{x} 0.37 0.2  {x + 0.4} 0.37 '
                   f'0.2  {x + 0.4} 0.37 0.6  {x} 0.37 0.6] '
                   f'"integer indices" [0 1 2 0 2 3]'
                   f' "float uv" [0 0 1 0 1 1 0 1]')
    return "\n".join(out)


def write_all_classes_scene(d, seed=0) -> str:
    """The scene file and its maps under directory `d`, from `seed`."""
    rng = np.random.default_rng(seed)
    imageio.write_pfm(os.path.join(d, "img.pfm"),
                      rng.uniform(0, 1, (32, 64, 3)).astype(np.float32))
    imageio.write_exr(os.path.join(d, "img.exr"),
                      rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    env = rng.uniform(0.1, 0.6, (16, 32, 3)).astype(np.float32)
    env[3, 7] = [40.0, 36.0, 30.0]   # a sun texel
    imageio.write_exr(os.path.join(d, "env.exr"), env)
    imageio.write_pfm(os.path.join(d, "gonio.pfm"),
                      rng.uniform(0, 1, (8, 16, 3)).astype(np.float32))
    imageio.write_exr(os.path.join(d, "proj.exr"),
                      rng.uniform(0, 1, (12, 16, 3)).astype(np.float32))
    faces = [rng.uniform(0, 1, (4, 8, 3)).astype(np.float32),
             rng.uniform(0, 1, (8, 4, 3)).astype(np.float32)]
    ptex.write_ptex(os.path.join(d, "faces.ptx"), faces)
    path = os.path.join(d, "all_classes.pbrt")
    with open(path, "w") as f:
        f.write(ALL_CLASSES.replace("{materials}", _others()))
    return path


def _flat_both(tmp_path):
    path = write_all_classes_scene(str(tmp_path))
    d = os.path.dirname(path)
    return jax_flatten(jax_parse_file(path), d), flatten(parse_file(path), d)


def test_tables_of_all_fourteen_classes_are_array_equal(tmp_path):
    """TextureTable.arrays(), the MIP offsets and levels among them, the
    materials' texture ids, the light-map atlas and rows, and the
    environment map: the same arrays in both packages."""
    sj, sp = _flat_both(tmp_path)
    tj, tp = sj.textures, sp.textures
    assert set(tj) == set(tp) == set(tex.TEX_FIELDS)
    for k in tex.TEX_FIELDS:
        a, b = np.asarray(tj[k]), np.asarray(tp[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    types = set(int(x) for x in tp["tex_type"])
    assert types == set(range(14)), sorted(types)
    assert int(tp["tex_mips"].max()) == 7      # 64x32 -> 1x1
    assert int(tp["tex_ptex_off"].shape[0]) == 2
    for k in ("kd_tex", "ks_tex", "kd"):
        np.testing.assert_array_equal(getattr(sp.materials, k),
                                      getattr(sj.materials, k), err_msg=k)
    for k in ("type", "L", "pos", "w2l", "img_off", "img_w", "img_h", "img",
              "cos_total"):
        np.testing.assert_array_equal(getattr(sp.lights, k),
                                      getattr(sj.lights, k), err_msg=k)
    assert sp.env_light_id == sj.env_light_id == 0
    np.testing.assert_array_equal(sp.env_map, sj.env_map)
    np.testing.assert_array_equal(sp.env_w2l, sj.env_w2l)


def test_ptex_files_read_the_same_in_both(tmp_path):
    """A file of the port's writer reads back the same faces through both
    packages' readers (uint8 quantised), in each encoding."""
    rng = np.random.default_rng(4)
    faces = [rng.uniform(0, 1, (8, 8, 3)).astype(np.float32),
             np.full((2, 4, 3), 0.25, np.float32)]
    for tile in (0, 4):
        path = str(tmp_path / f"t{tile}.ptx")
        ptex.write_ptex(path, faces, tile=tile)
        ours, _ = ptex.read_ptex(path)
        theirs, _ = jax_ptex.read_ptex(path)
        for a, b, f in zip(ours, theirs, faces):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, f, atol=1.0 / 255 + 1e-6)


def _lanes(tp, seed):
    """N_LANES seeded lanes for every texture row: (tex_id, uv, p, width,
    aniso, face) as numpy arrays."""
    rng = np.random.default_rng(seed)
    n_rows = len(tp["tex_type"])
    tid = np.repeat(np.arange(n_rows, dtype=np.int32), N_LANES)
    n = len(tid)
    uv = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv[::17] *= 300.0     # some lanes far out in uv (|uv| <= 1e3)
    p = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    p[::13] *= 8.0
    width = np.exp(rng.uniform(-9, 1, n)).astype(np.float32)
    aniso = (rng.normal(0, 1, (n, 2))
             * np.exp(rng.uniform(-7, 0, (n, 1)))).astype(np.float32)
    face = rng.integers(-1, 4, n).astype(np.int32)
    return tid, uv, p, width, aniso, face


_JAX_CACHE = {}


def _jax_eval(tmp_path_factory, mode):
    """tpupt's eval_texture over every row's lanes, once per mode: it
    computes every type on every lane, so one call serves all types."""
    if mode not in _JAX_CACHE:
        d = tmp_path_factory.mktemp("tex")
        sj, sp = _flat_both(d)
        tp = sp.textures
        tid, uv, p, width, aniso, face = _lanes(tp, 11)
        w = None if mode == "point" else width
        a = aniso if mode == "aniso" else None
        out = jax_tex.eval_texture(
            {k: jnp.asarray(v) for k, v in sj.textures.items()},
            jnp.asarray(tid), jnp.asarray(uv), jnp.asarray(p),
            width=None if w is None else jnp.asarray(w),
            aniso=None if a is None else jnp.asarray(a),
            face=jnp.asarray(face))
        _JAX_CACHE[mode] = (tp, np.asarray(out))
    return _JAX_CACHE[mode]


def _port_eval(tp, mode, types):
    tid, uv, p, width, aniso, face = _lanes(tp, 11)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in tp.items()}
    return tex.eval_texture(
        t, torch.from_numpy(tid), torch.from_numpy(uv), torch.from_numpy(p),
        width=None if mode == "point" else torch.from_numpy(width),
        aniso=torch.from_numpy(aniso) if mode == "aniso" else None,
        face=torch.from_numpy(face), types=types).numpy(), tid


@pytest.mark.parametrize("mode", ["point", "trilinear", "aniso"])
@pytest.mark.parametrize("ttype", range(14))
def test_eval_texture_matches_jax_per_type(ttype, mode, tmp_path_factory):
    """Each texture type on 4,096 seeded (uv, p, width, aniso, face) lanes
    of its rows, computed alone (the type set of a scene that uses only it),
    against tpupt's eval_texture, which computes every type: within
    TEX_ATOL."""
    tp, want = _jax_eval(tmp_path_factory, mode)
    got, tid = _port_eval(tp, mode, frozenset({ttype}))
    rows = np.nonzero(np.asarray(tp["tex_type"]) == ttype)[0]
    sel = np.isin(tid, rows)
    assert sel.sum() >= N_LANES
    err = np.abs(got[sel] - want[sel]).max()
    assert np.isfinite(got[sel]).all()
    assert err <= TEX_ATOL, f"type {ttype}, {mode}: {err}"
    if ttype not in (tex.TEX_CONSTANT,):
        assert np.ptp(got[sel]) > 0.01  # the lanes do vary


def test_present_types_compute_the_same_values_as_all(tmp_path):
    """Computing only the types present gives, on those types' lanes, the
    very values of computing every type; the other lanes keep their row's
    v1."""
    _, sp = _flat_both(tmp_path)
    tp = sp.textures
    every, tid = _port_eval(tp, "aniso", tex.ALL_TYPES)
    some = frozenset({tex.TEX_IMAGEMAP, tex.TEX_MARBLE, tex.TEX_CHECKER})
    part, _ = _port_eval(tp, "aniso", some)
    types = np.asarray(tp["tex_type"])[tid]
    on = np.isin(types, list(some))
    np.testing.assert_array_equal(part[on], every[on])
    np.testing.assert_array_equal(part[~on], np.asarray(tp["tex_v1"])[tid][~on])
    kd, ks = tex.present_types(tp["tex_type"], sp.materials.kd_tex,
                               sp.materials.ks_tex)
    assert kd == set(range(14)) - {tex.TEX_CONSTANT, tex.TEX_MARBLE}
    assert ks == {tex.TEX_MARBLE}


def _dist_funcs():
    """2D functions with all-zero rows, repeated cdf values (zero runs and
    equal entries) and a single bright texel."""
    rng = np.random.default_rng(7)
    f = rng.uniform(0, 1, (9, 13)).astype(np.float32)
    f[2] = 0.0                       # an all-zero row: uniform cdf
    f[5, 3:8] = 0.0                  # repeated cdf values inside a row
    f[6] = 0.25                      # ties everywhere
    g = np.zeros((6, 10), np.float32)
    g[1, 4] = 100.0                  # one bright texel, zero elsewhere
    g[4, :] = 1.0
    return {"mixed": f, "spike": g}


def _u(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 1, (2, n)).astype(np.float32)
    # exact cdf values and the ends
    u[:, :40] = np.linspace(0, 1, 40, endpoint=False, dtype=np.float32)
    return u


@pytest.mark.parametrize("name", ["mixed", "spike"])
def test_distributions_match_jax(name):
    """Host-built tables within 1e-6 of the JAX package's; on its tables,
    Distribution1D (continuous, discrete, discrete_pdf) and Distribution2D
    (continuous, pdf) give the same offsets and samples / pdfs within 1e-6
    relative. The row search never gathers (N, W+1) cdf rows."""
    f = _dist_funcs()[name]
    dj = JaxD2.build(jnp.asarray(f))
    ours = build_distribution2d(f)
    for a, b in zip(dj, ours):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)
    u1, u2 = _u(4096, 3)
    d2 = Distribution2D(*(torch.from_numpy(np.asarray(x)) for x in dj))
    (uu, vv), pdf = d2.sample_continuous(torch.from_numpy(u1),
                                         torch.from_numpy(u2))
    (uj, vj), pdfj = dj.sample_continuous(jnp.asarray(u1), jnp.asarray(u2))
    h, w = f.shape
    np.testing.assert_array_equal(np.floor(uu.numpy() * w),
                                  np.floor(np.asarray(uj) * w))
    np.testing.assert_array_equal(np.floor(vv.numpy() * h),
                                  np.floor(np.asarray(vj) * h))
    for a, b in ((uu, uj), (vv, vj), (pdf, pdfj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    pj = dj.pdf(jnp.asarray(u1), jnp.asarray(u2))
    np.testing.assert_allclose(d2.pdf(torch.from_numpy(u1),
                                      torch.from_numpy(u2)).numpy(),
                               np.asarray(pj), rtol=1e-6)

    row = f[1] if name == "mixed" else f[0] * 0.0   # the second: all zero
    d1j = JaxD1.build(jnp.asarray(row))
    d1 = Distribution1D(*(torch.from_numpy(np.asarray(x)) for x in d1j))
    for a, b in zip(build_distribution1d(row), d1j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    x, p, off = d1.sample_continuous(torch.from_numpy(u1))
    xj, pj, offj = d1j.sample_continuous(jnp.asarray(u1))
    np.testing.assert_array_equal(off.numpy(), np.asarray(offj))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-6)
    off, pmf = d1.sample_discrete(torch.from_numpy(u2))
    offj, pmfj = d1j.sample_discrete(jnp.asarray(u2))
    np.testing.assert_array_equal(off.numpy(), np.asarray(offj))
    np.testing.assert_allclose(pmf.numpy(), np.asarray(pmfj), rtol=1e-6)
    idx = np.arange(len(row))
    np.testing.assert_allclose(
        d1.discrete_pdf(torch.from_numpy(idx)).numpy(),
        np.asarray(d1j.discrete_pdf(jnp.asarray(idx))), rtol=1e-6)
