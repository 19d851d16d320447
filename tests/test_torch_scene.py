"""tpupt_torch host side against the JAX package: parse -> flatten -> upload
give array-equal tables, and `from_numpy` carries the JAX package's tables
across unchanged."""

import os

import numpy as np
import pytest
import torch

from tpupt.scene.device import upload as jax_upload
from tpupt.scene.flatten import flatten as jax_flatten
from tpupt.scene.loader import parse_file as jax_parse_file
from tpupt.scene.loader import parse_string as jax_parse_string
from tpupt_torch.scene.device import (TWO_LEVEL_FIELDS, DeviceScene,
                                      SceneStatics, from_numpy, upload)
from tpupt_torch.scene.flatten import flatten
from tpupt_torch.scene.loader import parse_file, parse_string
from tpupt_torch.tools import genscene, testscenes

_TEXT_SCENES = {
    "random_triangles": lambda: testscenes.random_triangles_pbrt(60, 0),
    "triangles_and_spheres": lambda: testscenes.random_triangles_pbrt(60, 5),
    "quadric_kinds": testscenes.quadric_kinds_pbrt,
}


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
        if f in TWO_LEVEL_FIELDS:
            # one-row dummies here; tests/test_torch_treelets.py holds the
            # two-level tables against the JAX package's
            assert getattr(ds_t, f).shape[0] == 1, f
            continue
        _assert_same_bits(f, getattr(ds_j, f), getattr(ds_t, f).numpy())
    for f in SceneStatics._fields:
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
        if f not in TWO_LEVEL_FIELDS:  # rebuilt in this package's layout
            _assert_same_bits(f, fields[f], t.numpy())
    assert st_t.n_spheres == 7 and st_t.max_leaf == st_j.max_leaf


def test_from_numpy_refuses_unported_statics(tmp_path):
    sj, _ = _both("random_triangles", tmp_path)
    fields, statics = testscenes.tables_as_numpy(*jax_upload(sj))
    statics["has_motion"] = True
    with pytest.raises(NotImplementedError, match="has_motion"):
        from_numpy(fields, statics, device="cpu")


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    _, sc = _both("random_triangles", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        upload(sc, device="cuda")


_UNPORTED = {
    "texture": 'Texture "t" "spectrum" "checkerboard"\nMaterial "matte" "texture Kd" "t"',
    "disney": 'Material "disney"',
    "infinite": 'LightSource "infinite"',
    "medium": 'MakeNamedMedium "fog" "string type" "homogeneous"',
}


@pytest.mark.parametrize("feature", list(_UNPORTED))
def test_unported_features_raise_not_implemented(feature):
    txt = f"""
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
{_UNPORTED[feature]}
Shape "sphere" "float radius" [1]
WorldEnd
"""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flatten(parse_string(txt))


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
