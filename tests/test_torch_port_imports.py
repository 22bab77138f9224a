"""The port imports torch and never JAX or the JAX package, and
chip_smoke.py refuses to run without a GPU. The import checks read every
source of the port statically (imports inside functions included) and
import every module in a fresh interpreter."""

import ast
import builtins
import glob
import os
import re
import subprocess
import symtable
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT_SOURCES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "aero_tpu_torch", "**", "*.py"),
              recursive=True)) + ["chip_smoke.py"]
FORBIDDEN = ("aero_tpu", "jax", "jaxlib", "flax")
SHELL_SOURCES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "aero_tpu_torch", "**", "*.sh"),
              recursive=True))
# a quoted heredoc: <<'EOF' ... EOF
HEREDOC = re.compile(r"<<'(\w+)'\n(.*?)\n\1\n", re.S)


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


def test_shell_scripts_exist():
    assert "aero_tpu_torch/tools/repro_vctk.sh" in SHELL_SOURCES


@pytest.mark.parametrize("source", SHELL_SOURCES)
def test_port_shell_script_runs_nothing_of_jax_package(source):
    """The script's inline Python (its quoted heredocs) imports nothing of
    JAX or the JAX package, each ``-m`` module it runs is the port's, and
    it runs no Python file (the root scripts drive the JAX package)."""
    with open(os.path.join(ROOT, source)) as f:
        text = f.read()
    blocks = [body for _, body in HEREDOC.findall(text)]
    assert blocks, f"{source}: no inline Python found"
    for body in blocks:
        bad = sorted(name for name in _imported_modules(ast.parse(body))
                     if name.split(".")[0] in FORBIDDEN)
        assert not bad, f"{source} inline Python imports {bad}"
    shell = "\n".join(line for line in HEREDOC.sub("", text).splitlines()
                      if not line.lstrip().startswith("#"))
    modules = re.findall(r"-m\s+([\w.]+)", shell)
    assert modules and all(m.split(".")[0] == "aero_tpu_torch"
                           for m in modules), modules
    assert not re.findall(r"\S+\.py\b", shell)


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


# what every module has without binding it
MODULE_DUNDERS = {"__file__", "__name__", "__doc__", "__spec__", "__loader__",
                  "__package__", "__builtins__", "__cached__"}


def test_chip_smoke_names_are_defined():
    """Every global name a function of chip_smoke.py reads is bound at
    module level, imported, a builtin or a module dunder: the script runs
    on a GPU alone, where a name left behind would fail mid-way."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        top = symtable.symtable(f.read(), "chip_smoke.py", "exec")
    bound = {s.get_name() for s in top.get_symbols()
             if s.is_assigned() or s.is_imported()}
    bound |= set(dir(builtins)) | MODULE_DUNDERS
    missing, tables = set(), list(top.get_children())
    while tables:
        table = tables.pop()
        tables += table.get_children()
        missing |= {f"{table.get_name()}: {s.get_name()}"
                    for s in table.get_symbols()
                    if s.is_global() and s.is_referenced()
                    and s.get_name() not in bound}
    assert not missing, sorted(missing)


@pytest.mark.parametrize("module", ["aero_tpu_torch.parallel.mesh",
                                    "aero_tpu_torch.entry",
                                    "aero_tpu_torch.train.__main__",
                                    "aero_tpu_torch.utils.profiling"])
def test_data_parallel_modules_import_no_jax(module):
    """The data-parallel modules and the Solver's profiling, each alone in
    a fresh interpreter (a rank imports them first), bring in neither JAX
    nor the JAX package."""
    res = _run(["-c", f"import sys, {module}\n"
                "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
                f"{FORBIDDEN!r})\nassert not bad, bad"], ROOT)
    assert res.returncode == 0, res.stderr
