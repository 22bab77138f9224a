"""What the training tools of ``aero_tpu_torch/tools`` share: the train
CLI's command line, one run of it in a run directory, and the history it
leaves there."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import typing as tp

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the port's train CLI; the JAX tools run the root train.py instead
TRAIN = [sys.executable, "-m", "aero_tpu_torch.train"]


def run_train(cmd: tp.Sequence[str], run_dir: str, capture: bool = False
              ) -> subprocess.CompletedProcess:
    """``cmd`` as a subprocess in ``run_dir``, with the repository first on
    its PYTHONPATH (``-m`` needs the package on the path there)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run(list(cmd), cwd=run_dir, env=env, text=True,
                          capture_output=capture)


def load_history(run_dir: str) -> tp.Tuple[str, list]:
    """(path, entries) of the last ``history.json`` under ``run_dir`` in
    ``os.walk`` order (the train CLI writes one, in
    ``outputs/<dset>/<experiment>/``)."""
    path = None
    for root, _dirs, files in os.walk(run_dir):
        if "history.json" in files:
            path = os.path.join(root, "history.json")
    if path is None:
        raise FileNotFoundError(f"no history.json under {run_dir}")
    with open(path) as f:
        return path, json.load(f)
