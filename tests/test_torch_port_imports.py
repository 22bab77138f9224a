"""The port imports torch and never JAX, and chip_smoke.py refuses to run
without a GPU. Both checks run in fresh interpreters."""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

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
