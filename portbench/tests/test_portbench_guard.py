"""The import guard: no run holds JAX or the JAX package, and the
reference holds nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import _paths  # noqa: F401

import run

PORTBENCH = _paths.PORTBENCH


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["tpupt_torch", "tpupt_torch.ops",
                                  "numpy", "jaxtyping"]) == []
    assert run.forbidden_modules(["tpupt.scene.loader"]) == ["tpupt"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                  "torch"]) == ["flax", "jax", "jaxlib"]


def test_sources_import_no_jax():
    for path in glob.glob(os.path.join(PORTBENCH, "**", "*.py"),
                          recursive=True):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "tpupt"}, path


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "dataclasses", "numpy", "torch",
               "reference"}
    for path in glob.glob(os.path.join(PORTBENCH, "reference", "*.py")):
        assert set(_imports(path)) <= allowed, path
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.inverse, reference.path, reference.scene; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('tpupt_torch', 'tpupt', 'jax')]; print(bad); "
            "sys.exit(1 if bad else 0)" % PORTBENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with another code than 0 and
    prints no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(PORTBENCH, "run.py"), "--workload",
         "museum-grad-1024", "--seed", str(2**33 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=_paths.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
