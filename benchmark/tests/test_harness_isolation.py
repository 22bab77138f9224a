"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: ``aero_tpu_torch`` begins with ``aero_tpu``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not {"jax", "jaxlib", "flax", "aero_tpu"} & set(imported(path))


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "aero_tpu_torch" not in set(imported(path))


def test_names_are_compared_whole():
    from benchmark import harness

    assert harness.forbidden_modules() == []  # this process: the port only
    import sys
    import types
    sys.modules["aero_tpu_torch_probe"] = types.ModuleType("x")
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["aero_tpu_torch_probe"]
