"""``python -m aero_tpu_torch.bench`` as a subprocess on the CPU, at the tiny
config (``experiment=tiny dset=debug device=cpu precision=float32``,
``AERO_BENCH_BATCH=2 AERO_BENCH_ITERS=1``): one stdout line with the
repository's ``bench.py`` keys in serving (pipelined and latency) and train
mode, ``mfu`` and ``peak_tflops`` null off a GPU, and no run on the CPU
unless ``device=cpu`` says so.

The serving cases leave out the tiny config's one LocalState
(``experiment.aero.dconv_time_attn=2``): on 10 s chunks (T = 2501) its
plain attention takes ~25 s a forward on one CPU thread, five forwards a
run. The train case (T = 126) keeps it, and ``test_torch_port_flops.py``
holds the attention's count."""

import json
import math
import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.torch_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["experiment=tiny", "dset=debug", "precision=float32"]
KEYS = {
    "serving": ["metric", "value", "unit", "vs_baseline", "mode",
                "model_tflops", "mfu", "peak_tflops", "peak_dtype"],
    "train": ["metric", "value", "unit", "vs_baseline", "mode", "step_ms",
              "batch", "model_tflops", "mfu", "devices", "peak_tflops",
              "peak_dtype"]}
NO_ATTENTION = ["experiment.aero.dconv_time_attn=2"]
# mode: (environment, overrides, key set, metric)
MODES = {"pipelined": ({}, NO_ATTENTION, "serving", "realtime_factor"),
         "latency": ({"AERO_BENCH_PIPELINED": "0"}, NO_ATTENTION, "serving",
                     "realtime_factor"),
         "chained": ({"AERO_BENCH_TRAIN": "1"}, [], "train",
                     "train_throughput")}


def _bench(args, **env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("AERO_")}
    # one intra-op thread: the suite runs in several worker processes on
    # few cores, and torch's thread pools in each would contend for them
    full.update(AERO_BENCH_BATCH="2", AERO_BENCH_ITERS="1",
                OMP_NUM_THREADS="1", **env)
    return subprocess.run(
        [sys.executable, "-m", "aero_tpu_torch.bench", *args], cwd=ROOT,
        env=full, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_prints_one_line(mode):
    env, overrides, keys, metric = MODES[mode]
    proc = _bench(TINY + ["device=cpu"] + overrides, **env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert list(result) == KEYS[keys]
    assert (result["metric"], result["mode"]) == (metric, mode)
    assert result["mfu"] is None and result["peak_tflops"] is None
    assert result["peak_dtype"] == "bf16"
    for key in ("value", "vs_baseline", "model_tflops") + (
            ("step_ms",) if keys == "train" else ()):
        assert math.isfinite(result[key]) and result[key] > 0, result
    if keys == "train":
        assert (result["batch"], result["devices"]) == (2, 1)
    assert "launches of the counted call" in proc.stderr


def test_bench_needs_a_gpu_unless_told_cpu():
    proc = _bench(TINY, CUDA_VISIBLE_DEVICES="")  # no GPU, on any machine
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr
