"""The port imports torch and never JAX or the JAX package, and
chip_smoke.py refuses to run without a GPU. The import checks read every
source of the port statically (imports inside functions included) and
import every module in a fresh interpreter."""

import ast
import glob
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT_SOURCES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "aero_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
FORBIDDEN = ("aero_tpu", "jax", "jaxlib", "flax")


def _imported_modules(tree):
    """Every module name an ``import`` or ``from ... import`` names, at any
    depth of the tree; relative imports resolve inside the port."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


@pytest.mark.parametrize("source", PORT_SOURCES)
def test_port_source_imports_nothing_of_jax_package(source):
    with open(os.path.join(ROOT, source)) as f:
        tree = ast.parse(f.read(), filename=source)
    bad = sorted(name for name in _imported_modules(tree)
                 if name.split(".")[0] in FORBIDDEN)
    assert not bad, f"{source} imports {bad}"


def test_static_import_check_sees_nested_imports():
    tree = ast.parse("def f():\n    from aero_tpu.data import audio_io\n"
                     "    import jax.numpy as jnp\n")
    assert sorted(_imported_modules(tree)) == ["aero_tpu.data", "jax.numpy"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aero_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aero_tpu_torch.__path__,
                                                "aero_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax"))
assert not bad, bad
print(len(names))
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_import_no_jax():
    res = _run(["-c", _IMPORT_ALL], ROOT)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 12


def test_chip_smoke_fails_without_gpu():
    """Here there is no CUDA device: non-zero exit and no result line."""
    res = _run(["chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
