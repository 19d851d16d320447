"""tpupt_torch host side against the JAX package: parse -> flatten -> upload
give array-equal tables, and `from_numpy` carries the JAX package's tables
across unchanged."""

import os
import warnings

import numpy as np
import pytest
import torch

from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.scene.device import (ALT_FIELDS, ALT_STATICS, DT_WIDTH,
                                      TWO_LEVEL_FIELDS, DeviceScene,
                                      SceneStatics, from_numpy, upload)
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.textures.textures import present_types
from tpupt_torch.tools import genscene, testscenes

# one intra-op thread: the tier-1 run puts six test processes on the
# machine's cores, and more threads a process only make them compete
torch.set_num_threads(1)

_TEXT_SCENES = {
    "random_triangles": lambda: testscenes.random_triangles_pbrt(60, 0),
    "triangles_and_spheres": lambda: testscenes.random_triangles_pbrt(60, 5),
    "quadric_kinds": testscenes.quadric_kinds_pbrt,
}


# the vertex-lerp motion tables of DeviceScene
MOTION_FIELDS = ("prim_rows_dt", "tri_dp0", "tri_dp1", "tri_dp2")


def _both(name, tmp_path):
    if name == "museum":
        path = genscene.museum(str(tmp_path), grid=2, seg=8, rings=4)
        d = os.path.dirname(path)
        return jax_flatten(jax_parse_file(path), d), flatten(parse_file(path), d)
    txt = _TEXT_SCENES[name]()
    return jax_flatten(jax_parse_string(txt)), flatten(parse_string(txt))


def _assert_same_bits(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} vs {b.dtype}"
    assert a.tobytes() == b.tobytes(), f"{name}: values differ"


@pytest.mark.parametrize("name", list(_TEXT_SCENES) + ["museum"])
@pytest.mark.parametrize("strategy", ["spatial", "power"])
def test_upload_tables_array_equal(name, strategy, tmp_path):
    sj, st_ = _both(name, tmp_path)
    ds_j, st_j = jax_upload(sj, light_strategy=strategy)
    ds_t, st_t = upload(st_, light_strategy=strategy, device="cpu")
    for f in DeviceScene._fields:
        if f in TWO_LEVEL_FIELDS + ALT_FIELDS:
            # one-row dummies here; tests/test_torch_treelets.py holds the
            # two-level tables against the JAX package's,
            # tests/test_torch_kdbsp_build.py the kd / RBSP / BSP trees
            # (None in the JAX package's tables of a BVH scene)
            assert getattr(ds_t, f).shape[0] == 1, f
            continue
        if f == "sss_pack" and ds_j.sss_pack is None:
            # no subsurface rows: None there, a one-row dummy here
            assert tuple(ds_t.sss_pack.shape) == (1, 390)
            continue
        if f in MOTION_FIELDS:
            # a static scene: zeros there (a row a triangle for tri_dp*),
            # one-row zero dummies here (prim_rows_dt 12 wide);
            # tests/test_torch_motion.py holds a motion scene's tables
            t = getattr(ds_t, f).numpy()
            assert t.shape[0] == 1 and not t.any() and \
                not np.asarray(getattr(ds_j, f)).any(), f
            continue
        _assert_same_bits(f, getattr(ds_j, f), getattr(ds_t, f).numpy())
    for f in SceneStatics._fields:
        if f in ALT_STATICS:   # the port's own; the JAX Renderer keeps them
            assert not getattr(st_t, f), f
            continue
        if f == "tex_types":   # the port's own: the types materials name
            assert st_t.tex_types == present_types(
                ds_j.tex_type, ds_j.mat_kd_tex, ds_j.mat_ks_tex)
            continue
        if f == "mix_features":   # the port's own: no mix rows here
            assert st_t.mix_features == frozenset()
            continue
        assert getattr(st_j, f) == getattr(st_t, f), f
    assert st_j.two_level is False  # the JAX side took its single-level path


def test_from_numpy_carries_tables_across(tmp_path):
    sj, _ = _both("quadric_kinds", tmp_path)
    ds_j, st_j = jax_upload(sj, light_strategy="spatial")
    fields, statics = testscenes.tables_as_numpy(ds_j, st_j)
    ds_t, st_t = from_numpy(fields, statics, device="cpu")
    assert not hasattr(ds_t, "wide_nodes_tiled")  # TPU-only layouts dropped
    for f in DeviceScene._fields:
        t = getattr(ds_t, f)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        if f in ALT_FIELDS or f == "sss_pack":
            # no tree, no subsurface rows in these tables: one-row dummies
            assert t.shape[0] == 1 and f not in fields, f
        elif f == "prim_rows_dt":  # padded from 9 to DT_WIDTH columns
            _assert_same_bits(f, fields[f], t.numpy()[:, :9])
            assert t.shape[1] == DT_WIDTH and not t[:, 9:].any()
        elif f not in TWO_LEVEL_FIELDS:  # rebuilt in this package's layout
            _assert_same_bits(f, fields[f], t.numpy())
    assert st_t.n_spheres == 7 and st_t.max_leaf == st_j.max_leaf


_FOG_BALL = """
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
Integrator "volpath"
WorldBegin
MakeNamedMedium "fog" "string type" "homogeneous" "rgb sigma_a" [0.1 0.2 0.3]
AttributeBegin
Material "none"
MediumInterface "fog" ""
Shape "sphere" "float radius" [1]
AttributeEnd
Shape "trianglemesh" "point P" [-1 -1 3  1 -1 3  0 1 3] "integer indices" [0 1 2]
WorldEnd
"""


def test_from_numpy_refuses_unported_statics():
    """No static refuses any more: the spectral and media statics, the
    last ones that did (n_channels, n_media), come across from the JAX
    package's tables with the media tables, array-equal."""
    ds_j, st_j = jax_upload(jax_flatten(jax_parse_string(_FOG_BALL)),
                            spectral=True)
    fields, statics = testscenes.tables_as_numpy(ds_j, st_j)
    ds_t, st_t = from_numpy(fields, statics, device="cpu")
    assert (st_t.n_channels, st_t.n_media, st_t.has_med_interfaces) == (
        60, 1, True)
    for f in ("n_channels", "n_media", "camera_medium", "any_grid_media",
              "has_med_interfaces"):
        assert getattr(st_t, f) == getattr(st_j, f), f
    for f in DeviceScene._fields:
        if f.startswith("med_") or f.startswith("prim_med_"):
            _assert_same_bits(f, fields[f], getattr(ds_t, f).numpy())


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, sc = _both("random_triangles", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        upload(sc, device="cuda")


# the features of the last refusals: (scene lines, the step it takes). The
# other integrators' gradients and those with respect to the medium tables
# (queue 1 items 12 and 11) were refused until they were ported and now
# come back finite; a training step handed several devices in one process
# is refused by design (one process drives one card: parallel/mesh.py)
_UNPORTED = {
    "integrator": ("", "training step under bdpt"),
    "mesh": ("", "training step on two devices in one process"),
    "medium_gradients": ('MakeNamedMedium "fog" "string type" "homogeneous"',
                         "value_and_grad of a medium table"),
}

# features the port refused until they were ported: (scene lines, header
# line); each now flattens, uploads and renders
_PORTED = {
    "disney": ('Material "disney"', ""),
    "mix": ('Material "mix"', ""),
    "hair": ('Material "hair"', ""),
    "fourier": ('Material "fourier"', ""),
    "subsurface": ('Material "subsurface"', ""),
    "sampler": ("", 'Sampler "sobol"'),
    "realistic": ("", ""),
    "motion": ("ActiveTransform EndTime\nTranslate 0.2 0 0\n"
               "ActiveTransform All", ""),
    # media and volpath (queue 1, item 11): a global fog, and the volpath
    # integrator over it
    "medium": ('MakeNamedMedium "fog" "string type" "homogeneous" '
               '"rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.1 0.1 0.1]',
               ""),
    "volpath": ('MakeNamedMedium "fog" "string type" "homogeneous" '
                '"rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.1 0.1 0.1]',
                'Integrator "volpath"'),
    # the other integrators (queue 1, item 12), through Renderer; mlt and
    # sppm estimate with the path integrator there (their drivers are
    # integrators/mlt.py and sppm.py)
    "bdpt": ("", 'Integrator "bdpt"'),
    "mlt": ("", 'Integrator "mlt"'),
    "sppm": ("", 'Integrator "sppm"'),
    "directlighting": ("", 'Integrator "directlighting"'),
    "whitted": ("", 'Integrator "whitted"'),
    "ambientocclusion": ("", 'Integrator "ambientocclusion"'),
}


@pytest.mark.parametrize("feature", list(_UNPORTED))
def test_unported_features_raise_not_implemented(feature):
    """The features the port refused last: the training step under BDPT
    and the gradients with respect to a medium table now come back finite
    (queue 1 items 12 and 11 are ported). The one refusal left is the
    port's design, not a missing item: a training step handed several
    devices in one process raises ValueError naming `init_distributed`,
    and the same step on a list of one device trains."""
    from tpupt_torch.integrators.path import Renderer
    from tpupt_torch.parallel.mesh import train_step_fn

    lines, _ = _UNPORTED[feature]
    head = {"integrator": 'Integrator "bdpt"'}.get(feature, "")
    light = ("" if feature == "mesh" else
             'LightSource "distant" "point from" [0 0 5] "point to" [0 0 0]')
    txt = f"""
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
{head}
WorldBegin
{light}
{lines}
Shape "trianglemesh" "point P" [-1 -1 0  1 -1 0  1 1 0] "integer indices" [0 1 2]
WorldEnd
"""
    sc = flatten(parse_string(txt))
    if feature == "integrator":
        step, p0 = train_step_fn(sc, None, np.ones((8, 8, 3)), device="cpu")
        loss, new = step(p0, 0, 0.1)
        assert np.isfinite(float(loss)) and float(loss) > 0
        assert all(bool(torch.isfinite(v).all()) for v in new.values())
        return
    if feature == "medium_gradients":
        r = Renderer(sc, device="cpu")
        _, g, _ = r.value_and_grad(lambda f: f.rgb.sum(),
                                   {"med_sigma_a": r.ds.med_sigma_a})
        assert g["med_sigma_a"].shape == r.ds.med_sigma_a.shape
        assert bool(torch.isfinite(g["med_sigma_a"]).all())
        return
    with pytest.raises(ValueError, match="init_distributed"):
        train_step_fn(sc, ["cpu", "cpu"], np.zeros((8, 8, 3)), device="cpu")
    step, p0 = train_step_fn(sc, ["cpu"], np.ones((8, 8, 3)))
    loss, new = step(p0, 0, 0.1)
    assert float(loss) == 3.0 and set(new) == set(p0)


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """No silent fall-back to the LBVH when the sweep-SAH code cannot be
    compiled: the error reaches the caller."""
    from tpupt_torch import native

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    (tmp_path / "missing.cpp").write_text("this is not C++")
    _, sc = _both("random_triangles", tmp_path)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        upload(sc, device="cpu")


@pytest.mark.parametrize("feature", list(_PORTED))
def test_formerly_unported_features_render(feature, tmp_path):
    """The scene lines of each feature the port refused before it was
    ported (the Disney, mix, hair, Fourier and subsurface materials, the
    sobol sampler, the realistic camera, motion blur, media, the volpath
    integrator and the other integrators) flatten, upload and render on the CPU, with finite pixels,
    under a distant light."""
    from tpupt_torch.integrators.path import Renderer

    lines, head = _PORTED[feature]
    camera = 'Camera "perspective" "float fov" [45]'
    if feature == "realistic":
        lens = testscenes.write_lens_file(str(tmp_path / "lens.dat"))
        camera = (f'Camera "realistic" "string lensfile" ["{lens}"] '
                  '"float focusdistance" [3]')
    txt = f"""
{camera}
Film "image" "integer xresolution" [8] "integer yresolution" [8]
{head}
WorldBegin
LightSource "distant" "point from" [0 0 -5] "point to" [0 0 0] "rgb L" [2 2 2]
{lines}
Shape "trianglemesh" "point P" [-1 -1 3  1 -1 3  0 1 3] "integer indices" [0 1 2]
WorldEnd
"""
    with warnings.catch_warnings():
        # the bare mix names no children, the bare fourier no file
        warnings.simplefilter("ignore")
        sc = flatten(parse_string(txt))
    ds, st = upload(sc, device="cpu")
    r = Renderer(sc, device="cpu", tables=(ds, st))
    img = r.image(r.render(spp=1))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    if feature == "sampler":
        assert r.sampler.name == "sobol" and img.mean() > 0
    elif feature == "realistic":
        assert sc.camera.lens_data.shape == (6, 4) and r.pupil is not None
    elif feature == "motion":
        assert st.has_motion and not st.cam_animated
    elif feature in ("medium", "volpath"):
        # the fog is the camera medium (named media, no interface); path
        # renders through it unattenuated, volpath through volpath_li
        assert (st.n_media, st.camera_medium) == (1, 0)
        assert (sc.integrator.name == "volpath") == (feature == "volpath")
        assert img.mean() > 0
    elif head.startswith("Integrator"):
        assert sc.integrator.name == feature and img.mean() > 0
    else:
        assert st.mat_features
