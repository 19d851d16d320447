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
