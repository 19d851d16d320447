"""The PyTorch package stands alone: importing all of it pulls in neither
`jax` nor the JAX package `tpupt`, and `chip_smoke.py` imports neither."""

import ast
import os
import pkgutil
import subprocess
import sys

import tpupt_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(tpupt_torch.__file__)))


def _module_names():
    names = ["tpupt_torch"]
    for m in pkgutil.walk_packages(tpupt_torch.__path__, "tpupt_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax_or_tpupt():
    names = _module_names()
    assert len(names) > 30
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'tpupt' or "
        "m.startswith('tpupt.'))\n"
        "print('BAD', bad)\n"
        "print('TRITON', 'triton' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "TRITON False" in out.stdout


def test_the_kd_bsp_modules_are_among_them():
    """The kd / RBSP / BSP slice: its walker, its kernel's wrapper and the
    native builders import without building anything and without a card."""
    names = set(_module_names())
    assert {"tpupt_torch.accel.kdbsp", "tpupt_torch.ops.traverse_kdbsp",
            "tpupt_torch.native"} <= names
    code = (
        "import sys\n"
        "import tpupt_torch.native as n, tpupt_torch.ops.traverse_kdbsp as k\n"
        "assert all(hasattr(n, f) for f in ('build_kdtree', 'build_rbsp', "
        "'build_bsp', 'polytope_cut_area', 'build_bvh_sah'))\n"
        "assert n._LIB is None and k._LIB is None and k.launches == 0\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout
    for src in ("tpupt_torch/csrc/traverse_kdbsp.cu",
                "tpupt_torch/native/builders.cpp"):
        assert os.path.exists(os.path.join(ROOT, src)), src


def test_the_requeue_modules_are_among_them():
    """The re-queue slice: its driver and kernel wrappers import without
    building anything and without a card, with both launch counts at 0."""
    assert "tpupt_torch.ops.traverse_requeue" in set(_module_names())
    code = (
        "import sys\n"
        "import tpupt_torch.ops.traverse_requeue as r\n"
        "assert r._LIB is None\n"
        "assert r.launches == {'bin_rays': 0, 'walk_pairs': 0}\n"
        "assert all(hasattr(r, f) for f in ('bin_rays_cuda', "
        "'walk_pairs_cuda', 'intersect_requeue', 'check_stack_depth'))\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout
    assert os.path.exists(os.path.join(ROOT, "tpupt_torch/csrc/traverse_requeue.cu"))


def test_the_gradient_modules_are_among_them():
    """The differentiable render: the hit recorder and the one-device
    training step import without a card and without jax or tpupt."""
    names = set(_module_names())
    assert {"tpupt_torch.integrators.replay",
            "tpupt_torch.parallel.mesh"} <= names
    code = (
        "import sys\n"
        "from tpupt_torch.parallel.mesh import PARAMS, train_step_fn\n"
        "from tpupt_torch.integrators.path import Renderer\n"
        "assert hasattr(Renderer, 'value_and_grad') and len(PARAMS) == 8\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_only_the_port():
    roots = _imported_roots(os.path.join(ROOT, "chip_smoke.py"))
    assert "tpupt_torch" in roots
    assert not roots & {"jax", "jaxlib", "tpupt"}


def test_no_source_file_of_the_port_names_jax_or_tpupt_imports():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tpupt_torch")):
        for f in files:
            if f.endswith(".py"):
                roots = _imported_roots(os.path.join(dirpath, f))
                assert not roots & {"jax", "jaxlib", "tpupt"}, (dirpath, f)


def test_the_appearance_modules_are_among_them():
    """The appearance slice: textures, the ptex codec, the sampling
    distributions and the light module import without a card and without
    jax or tpupt, and PIL (which the card's machine lacks) only when a PNG
    is read."""
    names = set(_module_names())
    assert {"tpupt_torch.textures.textures", "tpupt_torch.textures.ptex",
            "tpupt_torch.core.sampling", "tpupt_torch.lights.lights"} <= names
    code = (
        "import sys\n"
        "import tpupt_torch.textures.textures as t\n"
        "import tpupt_torch.textures.ptex as p\n"
        "from tpupt_torch.core.sampling import Distribution2D\n"
        "from tpupt_torch.lights.lights import sample_env, env_pdf\n"
        "from tpupt_torch.scene.flatten import flatten\n"
        "assert len(t.ALL_TYPES) == 14 and hasattr(p, 'write_ptex')\n"
        "print('PIL', 'PIL' in sys.modules)\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout and "PIL False" in out.stdout


def test_the_motion_camera_and_tool_modules_are_among_them():
    """The cameras-and-motion slice and its tools: the realistic camera,
    the sweep, the scene printer and the logging / profiler glue import
    without a card, without building anything and without jax or tpupt;
    K1's wrapper starts with both launch counts at 0."""
    names = set(_module_names())
    assert {"tpupt_torch.cameras.realistic", "tpupt_torch.tools.sweep",
            "tpupt_torch.tools.catscene", "tpupt_torch.utils.logging"} <= names
    code = (
        "import sys\n"
        "import tpupt_torch.ops.traverse_wide as w\n"
        "from tpupt_torch.cameras.realistic import realistic_rays\n"
        "from tpupt_torch.tools import catscene, sweep, render\n"
        "from tpupt_torch.utils import logging\n"
        "assert w._LIB is None and w.launches == w.launches_motion == 0\n"
        "assert all(hasattr(logging, f) for f in ('set_level', "
        "'set_logfile', 'annotate', 'profile_to'))\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout


def test_the_spectral_and_media_modules_are_among_them():
    """The spectral and media slice: the spectrum tables (the CIE data file
    copied beside them), the media, the volpath integrator and K6's wrapper
    with its backward (the autograd Functions, the backward entry point and
    its plain version) import without a card, without building anything
    and without jax or tpupt; K6's launch counts start at 0."""
    names = set(_module_names())
    assert {"tpupt_torch.core.spectrum", "tpupt_torch.media.media",
            "tpupt_torch.integrators.volpath",
            "tpupt_torch.ops.media_tracking"} <= names
    code = (
        "import sys\n"
        "import tpupt_torch.ops.media_tracking as k6\n"
        "from tpupt_torch.core import spectrum\n"
        "from tpupt_torch.integrators.volpath import volpath_li\n"
        "from tpupt_torch.media.media import (tr_lane, sample_distance_lane, "
        "tr_grid_backward_plain)\n"
        "from tpupt_torch.ops.media_tracking import (TrGrid, "
        "SampleDistanceGrid, tr_grid_backward)\n"
        "assert k6._LIB is None\n"
        "assert k6.launches == {'tr_grid': 0, 'sample_distance_grid': 0, "
        "'tr_grid_backward': 0}\n"
        "assert spectrum.smits_tables() is not None\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout
    for src in ("tpupt_torch/csrc/media_tracking.cu",
                "tpupt_torch/core/cie_data.npz"):
        assert os.path.exists(os.path.join(ROOT, src)), src


def test_the_integrator_modules_are_among_them():
    """The other integrators: direct lighting / Whitted / AO, BDPT, MLT and
    SPPM import without a card and without jax or tpupt, every integrator
    `Renderer` renders is among those it differentiates, and the film
    has its splats."""
    names = set(_module_names())
    assert {"tpupt_torch.integrators.direct", "tpupt_torch.integrators.bdpt",
            "tpupt_torch.integrators.mlt",
            "tpupt_torch.integrators.sppm"} <= names
    code = (
        "import sys\n"
        "from tpupt_torch.integrators.direct import (direct_lighting_li, "
        "whitted_li, ao_li)\n"
        "from tpupt_torch.integrators.bdpt import bdpt_li, sample_le\n"
        "from tpupt_torch.integrators.mlt import MLTRenderer, PSSSampler\n"
        "from tpupt_torch.integrators.sppm import SPPMRenderer\n"
        "from tpupt_torch.film.film import add_splats\n"
        "from tpupt_torch.integrators.path import GRADIENT_INTEGRATORS\n"
        "assert set(GRADIENT_INTEGRATORS) == {'path', 'volpath', "
        "'directlighting', 'whitted', 'ambientocclusion', 'bdpt', 'mlt', "
        "'sppm'}\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout


def test_the_mesh_and_tool_modules_are_among_them():
    """The multi-process slice and the last four tools: the sharded
    renderer, the training step, the spawner, imgtool (its Hosek data file
    beside it), obj2pbrt, cyhair2pbrt and bsdftest import without a card,
    without a process group and without jax or tpupt."""
    names = set(_module_names())
    assert {"tpupt_torch.parallel.mesh", "tpupt_torch.tools.imgtool",
            "tpupt_torch.tools.obj2pbrt", "tpupt_torch.tools.cyhair2pbrt",
            "tpupt_torch.tools.bsdftest"} <= names
    code = (
        "import sys\n"
        "import torch.distributed as dist\n"
        "from tpupt_torch.parallel.mesh import (Mesh, ShardedRenderer, "
        "init_distributed, make_mesh, scaling_curve, spawn, train_step_fn)\n"
        "from tpupt_torch.tools import imgtool, obj2pbrt, cyhair2pbrt, "
        "bsdftest, render\n"
        "import os\n"
        "assert os.path.exists(imgtool.HOSEK_DATA)\n"
        "assert not dist.is_initialized() and make_mesh('cpu').size == 1\n"
        "print('JAX', any(m.split('.')[0] in ('jax', 'jaxlib', 'tpupt') "
        "for m in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX False" in out.stdout
