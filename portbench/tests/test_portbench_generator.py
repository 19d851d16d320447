"""The frozen museum generator: the triangle counts the configurations
state, and the scene files it writes."""

import os

import _paths  # noqa: F401
import numpy as np
import pytest

from generators import museum as museum_gen
from harness import scenes


def _nondegenerate(desc) -> int:
    n = 0
    for m in desc["meshes"]:
        a, b, c = (np.asarray(x, np.float32) for x in m["p"])
        n += int((np.linalg.norm(np.cross(b - a, c - a), axis=1) > 0).sum())
    return n


@pytest.mark.parametrize("grid,seg,rings,count", [
    (4, 64, 32, 63558), (8, 128, 64, 1032454)])
def test_triangle_counts(grid, seg, rings, count):
    """Triangles of non-zero area (the poles of each statue collapse)."""
    desc = museum_gen.museum_scene(grid, seg, rings, 7, 16, 16)
    assert _nondegenerate(desc) == count


def test_scene_files_cached(tmp_path, monkeypatch):
    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    conf = dict(name="m", generator="museum", grid=1, seg=8, rings=4,
                scene_seed=7)
    p = scenes.pbrt_file(conf, 40, 30)
    text = open(p).read()
    assert '"integer xresolution" [40]' in text
    assert '"integer yresolution" [30]' in text
    ply = tmp_path / os.path.basename(os.path.dirname(p)) / "museum.ply"
    mtime = ply.stat().st_mtime_ns
    assert scenes.pbrt_file(conf, 40, 30) == p
    assert ply.stat().st_mtime_ns == mtime


def test_program_reads_the_same_scene(tmp_path, monkeypatch):
    """The program's flattened scene and the reference's plain data agree
    on the triangles, the materials and the lights."""
    from tpupt_torch.scene.flatten import flatten
    from tpupt_torch.scene.loader import parse_file

    monkeypatch.setattr(scenes, "CACHE", str(tmp_path))
    conf = dict(name="m", generator="museum", grid=1, seg=8, rings=4,
                scene_seed=7)
    p = scenes.pbrt_file(conf, 40, 30)
    sc = flatten(parse_file(p), os.path.dirname(p))
    desc = scenes.reference_scene(conf, 40, 30)
    total = sum(len(m["p"][0]) for m in desc["meshes"])
    # the flattener drops some of the statues' collapsed pole triangles,
    # which no ray hits
    assert _nondegenerate(desc) <= sc.triangles.count <= total
    assert sc.film.xres == 40 and sc.film.yres == 30
    np.testing.assert_allclose(sc.lights.L[2], museum_gen.DISTANT_L)
    np.testing.assert_allclose(sc.materials.kd[2], museum_gen.STATUE_KD,
                               rtol=1e-6)
