"""Per-ray reverse-mode gradients of the PyTorch port against the JAX
package's `jax.grad` on test_torch_gradients' small materials museum, and
the two divergences of the JAX package that the comparison meets there: its
hair lobes on other lanes, which make its kd gradient NaN, and its
subsurface probe, which is not detached. Split from
test_torch_gradients.py, whose helpers and tolerances it shares, so that
the tier-1 run can spread the two files over its workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpupt.cameras.perspective import generate_rays as jax_generate_rays
from tpupt.integrators.path import Renderer as JaxRenderer
from tpupt.integrators.path import path_li as jax_path_li
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.integrators.path import Renderer
from tpupt_torch.materials import bsdf as tbsdf
from tpupt_torch.scene.device import from_numpy
from tpupt_torch.scene.flatten import MAT_HAIR, flatten
from tpupt_torch.scene.loader import parse_string
from tpupt_torch.tools import testscenes

from test_differentiable import _SCENE2
from test_torch_gradients import (_close_grads, _jax_walkers,
                                  per_ray_gradients_match_jax)

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["materials"])
def test_per_ray_gradients_match_jax(name, tmp_path, monkeypatch):
    """d/dtheta of sum(W * L) for a fixed random W, L the per-ray radiance
    of path_li over the renderer's camera rays of sample 0, with respect to
    the bench's four tables; the JAX package's mat_kd gradient is NaN on
    the rows of materials other than hair
    (test_hair_lobes_of_other_lanes_make_the_jax_kd_gradient_nan), so mat_kd
    is compared on its other rows."""
    per_ray_gradients_match_jax(name, tmp_path, monkeypatch)


def test_hair_lobes_of_other_lanes_make_the_jax_kd_gradient_nan():
    """The JAX package evaluates its hair lobes on every lane, with each
    row's own extra[0:3] as (beta_m, beta_n, alpha): on a row whose
    extra[1] is 0 (a matte, plastic, metal or Fourier row; a Disney row
    without sheen) the logistic scale is 0 and the azimuthal term NaN, and
    that NaN times the discarded lane's zero cotangent reaches kd (sigma_a,
    through the attenuation). Its kd gradient is NaN on exactly those rows;
    the port evaluates the other lanes with the default fiber, and its
    gradient is finite there and equal on the hair rows."""
    from tpupt.materials import bsdf as jb

    txt = _SCENE2.replace('"02sequence"', '"halton"').replace(
        'WorldEnd', 'Material "hair" "float beta_n" [0.4]\n'
        'Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0] '
        '"integer indices" [0 1 2]\nWorldEnd')
    sj = jax_flatten(jax_parse_string(txt))
    rj = JaxRenderer(sj)
    dt, st = from_numpy(*testscenes.tables_as_numpy(rj.ds, rj.st),
                        device="cpu")
    types = dt.mat_type.numpy()
    gen = np.random.default_rng(4)
    n = 64 * len(types)
    mat = np.repeat(np.arange(len(types), dtype=np.int32), 64)
    wo, wi = (gen.normal(0, 1, (n, 3)).astype(np.float32) for _ in range(2))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    uv = gen.random((n, 2)).astype(np.float32)
    feats = frozenset({"hair"})

    def jax_f(kd):
        mp = jb.gather_mat_params(rj.ds._replace(mat_kd=kd),
                                  jnp.asarray(mat), uv=jnp.asarray(uv))
        f, pdf = jb.eval_pdf(mp, jnp.asarray(wo), jnp.asarray(wi), feats)
        return f.sum() + pdf.sum()

    gj = np.asarray(jax.grad(jax_f)(rj.ds.mat_kd))
    kd = dt.mat_kd.clone().requires_grad_()
    mp = tbsdf.gather_mat_params(dt._replace(mat_kd=kd), torch.from_numpy(mat),
                                 uv=torch.from_numpy(uv))
    f, pdf = tbsdf.eval_pdf(mp, torch.from_numpy(wo), torch.from_numpy(wi),
                            feats)
    (gt,) = torch.autograd.grad(f.sum() + pdf.sum(), kd)
    zero_bn = dt.mat_extra.numpy()[:, 1] == 0
    assert zero_bn.any() and (types == MAT_HAIR).any()
    np.testing.assert_array_equal(~np.isfinite(gj).all(-1), zero_bn)
    assert torch.isfinite(gt).all()
    hair_rows = types == MAT_HAIR
    _close_grads({"mat_kd": gt[torch.from_numpy(hair_rows)]},
                 {"mat_kd": gj[hair_rows]}, "hair rows")


def test_subsurface_probe_is_detached_in_the_port():
    """The subsurface exit's probe ray starts at the hit point, which moves
    with the camera. The JAX package hands its probe to the raw traversal
    (integrators/path.py:665, materials/bssrdf.py:150), not to the detaching
    wrapper, so jax.grad with respect to the camera matrices of a scene
    with a subsurface material raises (reverse mode through its walker's
    loop); with respect to the material and light tables the probe's inputs
    carry no tangent and it differentiates (the materials case of
    test_per_ray_gradients_match_jax). The port detaches every traversal
    input, the probe's too (its replay requires it), and its camera
    gradient on the same scene is finite and nonzero."""
    from test_torch_materials import _SLAB

    sj = jax_flatten(jax_parse_string(_SLAB))
    rj = JaxRenderer(sj)
    isect, isect_p = _jax_walkers(rj.st)
    n = rj.batch

    def jax_L(cam_to_world):
        ds = rj.ds._replace(cam_to_world=cam_to_world)
        o, d = jax_generate_rays(sj.camera.type, ds.raster_to_camera,
                                 ds.cam_to_world,
                                 jnp.stack([rj.px, rj.py], -1).astype(
                                     jnp.float32) + 0.5,
                                 jnp.zeros((n, 2)), 0.0, 1.0)
        L, _ = jax_path_li(ds, rj.st, rj.sampler, 1, 1.0, rj.px, rj.py,
                           jnp.uint32(0), o, d, isect=isect,
                           isect_p=isect_p, unroll=True)
        return L.sum()

    with pytest.raises(ValueError, match="Reverse-mode differentiation"):
        jax.grad(jax_L)(rj.ds.cam_to_world)
    r = Renderer(flatten(parse_string(_SLAB)), device="cpu")
    v, g, _ = r.value_and_grad(lambda f: f.rgb.sum(),
                               {"cam_to_world": r.ds.cam_to_world})
    assert r.st.mat_features == {"sss"} and float(v) > 0
    assert torch.isfinite(g["cam_to_world"]).all()
    assert float(g["cam_to_world"].abs().max()) > 0
