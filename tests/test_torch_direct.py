"""The direct-lighting, Whitted and ambient-occlusion integrators of the
PyTorch port against the JAX package's, and the film's splats, on the CPU
and on the JAX package's tables (carried across with `from_numpy`).

The JAX side renders through its own `Renderer._step_py`, batch by batch,
eagerly, with its XLA walkers jitted once per scene (test_torch_gradients
`_jax_walkers`); jitting its whole step would take longer than running it.
Tolerances: per pixel, film `rgb` and `weight` within rtol 1e-4, atol 1e-5
on at least 99.5 % of the pixels, as tests/test_torch_render.py holds the
path integrator's film (a last-bit difference can flip a lobe choice in
the others); measured: every pixel agrees, to 1.2e-6 at most. The
bottom-right pixel is left out, where the JAX film parks its masked
lanes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.film import film as jax_filmmod
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.film import film as filmmod
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes

from test_torch_gradients import _jax_walkers

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

PIXEL_RTOL, PIXEL_ATOL, PIXELS_AGREE = 1e-4, 1e-5, 0.995

# the smoke scene of tests/test_smoke_fast.py (area light, sphere, floor);
# "specular" puts a glass sphere, a mirror and a point light in it
SMOKE = """
LookAt 0 0 4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Film "image" "integer xresolution" [%(res)d] "integer yresolution" [%(res)d]
Sampler "halton" "integer pixelsamples" [1]
Integrator "%(integ)s" "integer maxdepth" [%(depth)d] %(extra)s
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "color L" [6 6 6]
  Translate 0 2.2 0
  Shape "trianglemesh" "point P" [-0.6 0 -0.6  0.6 0 -0.6  0.6 0 0.6  -0.6 0 0.6]
      "integer indices" [0 1 2 2 3 0]
AttributeEnd
%(more)s
Material "%(ball)s" "rgb Kd" [0.6 0.6 0.6]
Shape "sphere" "float radius" [0.8]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "trianglemesh" "point P" [-4 -1 -4  4 -1 -4  4 -1 4  -4 -1 4]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""
_MIRROR = """LightSource "point" "point from" [1.5 1.5 2] "color I" [3 3 3]
AttributeBegin
Material "mirror"
Shape "trianglemesh" "point P" [-3 -1 -2  3 -1 -2  3 2 -2  -3 2 -2]
  "integer indices" [0 1 2 2 3 0]
AttributeEnd"""


def smoke_text(integ, res=16, depth=3, extra="", specular=False):
    return SMOKE % dict(res=res, integ=integ, depth=depth, extra=extra,
                        more=_MIRROR if specular else "",
                        ball="glass" if specular else "matte")


def pair(text=None, path=None, spectral=False):
    """(jax Renderer with its walkers jitted once, port Renderer on the JAX
    package's tables) for a scene text or file."""
    if path is not None:
        d = os.path.dirname(path)
        sj = jax_flatten(jax_parse_file(path), d)
        sp = flatten(parse_file(path), d)
    else:
        sj = jax_flatten(jax_parse_string(text))
        sp = flatten(parse_string(text))
    rj = JaxRenderer(sj, spectral=spectral)
    rj._isect, rj._isect_p = _jax_walkers(rj.st)
    tables = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    return rj, Renderer(sp, device="cpu", tables=tables)


def jax_film(rj, sample_idx=0):
    """One sample of the JAX renderer, its step eager batch by batch."""
    f = jax_filmmod.new_film(rj.cfg.xres, rj.cfg.yres)
    for b in range(rj.n_batches):
        f = rj._step_py(rj.ds, f, jnp.uint32(sample_idx), rj._px_b[b],
                        rj._py_b[b], rj._valid_b[b])
    return f


def assert_films_agree(fj, ft, fields=("rgb", "weight")):
    n = ft.weight.shape[0]
    keep = np.ones(n, bool)
    keep[-1] = False  # where the JAX film parks its masked lanes
    ok = np.ones(n, bool)
    for f in fields:
        a = np.asarray(getattr(fj, f)).reshape(n, -1)
        b = getattr(ft, f).numpy().reshape(n, -1)
        assert np.isfinite(b).all(), f
        ok &= np.isclose(b, a, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    assert ok[keep].mean() >= PIXELS_AGREE, f"{(~ok[keep]).sum()} pixels differ"
    assert float(ft.rgb.sum()) > 0


def _museum(tmp_path, integ, extra=""):
    path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
    txt = open(path).read()
    head, body = txt.split("WorldBegin", 1)
    head = "\n".join(line for line in head.splitlines()
                     if not line.startswith(("Integrator", "Film", "Sampler")))
    head += ('\nFilm "image" "integer xresolution" [16] '
             '"integer yresolution" [16]\n'
             'Sampler "halton" "integer pixelsamples" [1]\n'
             f'Integrator "{integ}" "integer maxdepth" [2] {extra}\n')
    out = os.path.join(os.path.dirname(path), f"museum_{integ}.pbrt")
    with open(out, "w") as f:
        f.write(head + "WorldBegin" + body)
    return out


# case: (integrator, scene, Integrator parameters); the museum has an area
# and a distant light, so "one" picks between two
CASES = {
    "directlighting_all": ("directlighting", "museum", '"string strategy" "all"'),
    "directlighting_one": ("directlighting", "museum", '"string strategy" "one"'),
    "whitted": ("whitted", "specular", ""),
    "ao_cosine": ("ambientocclusion", "smoke", '"integer nsamples" [4]'),
    "ao_uniform": ("ambientocclusion", "smoke",
                   '"integer nsamples" [3] "bool cossample" "false"'),
}


@pytest.mark.parametrize("case", list(CASES))
def test_direct_family_film_matches_jax(case, tmp_path):
    integ, scene, extra = CASES[case]
    if scene == "museum":
        rj, rt = pair(path=_museum(tmp_path, integ, extra))
    else:
        rj, rt = pair(smoke_text(integ, extra=extra,
                                 specular=scene == "specular"))
    assert rt.scene.integrator.name == integ
    fj = jax_film(rj)
    ft = rt.render(spp=1)
    assert_films_agree(fj, ft)
    # no splats outside BDPT; the image is rgb / weight
    assert float(ft.splat.abs().sum()) == 0.0
    img = rt.image(ft)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_splats_and_their_scale_match_jax():
    """add_splats per pixel against the JAX package's (positions off the
    film clamp to its edge), and `Renderer.image`'s splat scale: 1 / the
    samples accumulated into the film, reset by a fresh render and carried
    on by a film passed back in (the JAX package's `_spp_rendered`)."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-2, 18, (500, 2)).astype(np.float32)
    L = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    r = Renderer(flatten(parse_string(smoke_text("bdpt", depth=1))),
                 device="cpu")
    cfg = r.cfg
    fj = jax_filmmod.add_splats(jax_filmmod.new_film(16, 16), cfg,
                                jnp.asarray(p), jnp.asarray(L))
    ft = filmmod.add_splats(r.new_film(), cfg, torch.from_numpy(p),
                            torch.from_numpy(L))
    np.testing.assert_allclose(ft.splat.numpy(), np.asarray(fj.splat),
                               rtol=1e-6, atol=1e-6)

    film = r.render(spp=2)
    assert r._spp_rendered == 2 and float(film.splat.sum()) > 0
    img = r.image(film)
    ref = filmmod.to_image(film, cfg, 0.5).numpy()
    np.testing.assert_array_equal(img, ref)
    film = r.render(spp=1, film=film)
    assert r._spp_rendered == 3
    np.testing.assert_array_equal(
        r.image(film), filmmod.to_image(film, cfg, 1.0 / 3.0).numpy())
    r.render(spp=1)
    assert r._spp_rendered == 1


def test_ao_caps_its_samples_at_sixteen(monkeypatch):
    """`Renderer` hands ao_li min(nsamples, 16), as the JAX package's step
    does."""
    from tpupt_torch.integrators import direct

    seen = []
    ao = direct.ao_li

    def spy(ds, st, sampler, n_samples, *a, **k):
        seen.append(n_samples)
        return ao(ds, st, sampler, n_samples, *a, **k)

    monkeypatch.setattr(direct, "ao_li", spy)
    sc = flatten(parse_string(smoke_text(
        "ambientocclusion", res=8, extra='"integer nsamples" [64]')))
    Renderer(sc, device="cpu").render(spp=1)
    assert seen == [16]
