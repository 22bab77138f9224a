"""Benchmark of the port: the AERO generator's realtime factor, or the GAN
train step's throughput (counterpart of the repository's ``bench.py``).

Usage::

    python -m aero_tpu_torch.bench [overrides]                   # serving
    AERO_BENCH_TRAIN=1 python -m aero_tpu_torch.bench [overrides] # training
    torchrun --nproc-per-node N -m aero_tpu_torch.bench ...      # N ranks

Defaults ``experiment=aero_4-16_512_64 dset=4-16 precision=bfloat16``; any
config override follows (``experiment=seanet_4-16``, ``precision=float32``,
``device=cpu``). The device is CUDA unless ``device=cpu`` is given; with no
GPU it raises. Environment: ``AERO_BENCH_BATCH`` (default 16),
``AERO_BENCH_ITERS`` (default 5 serving, 8 training),
``AERO_BENCH_PIPELINED`` (default 1), ``AERO_BENCH_TRAIN`` (default 0).

Serving: a batch of 10 s chunks from ``np.random.default_rng(0)``, scaled
by 0.1, through the generator in eval mode, after one warm-up. Pipelined
(the default): three repetitions, each launching ``iters`` forwards
asynchronously and then summing the outputs into one scalar that is fetched
once; the minimum over the repetitions. Latency
(``AERO_BENCH_PIPELINED=0``): a fetched scalar per forward, the median.

Training: the port's ``TrainStep`` at ``AERO_BENCH_BATCH`` x the config's
segment on seeded inputs, one warm-up, then three repetitions of ``iters``
chained steps; the median. Every step fetches its metrics as the train CLI
does, so steps do not overlap. Under torchrun each rank takes its share of
the global batch (rank 0's rows first), the counts and the peak cover every
rank, and rank 0 prints.

Prints ONE JSON line on stdout (logs go to stderr): serving keys
``metric value unit vs_baseline mode model_tflops mfu peak_tflops
peak_dtype``, training keys ``metric value unit vs_baseline mode step_ms
batch model_tflops mfu devices peak_tflops peak_dtype``. ``model_tflops``
is ``utils.flops.count_flops`` of one forward or one step, the same number
on every device and route; ``mfu`` is it over the time per call and the
cards' bf16 dense peak, null where there is no peak (the CPU, float32).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import statistics
import sys
import time

import numpy as np
import torch

from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.predict import CONF_DIR, SEGMENT_DURATION_SEC, \
    resolve_device
from aero_tpu_torch.train import build
from aero_tpu_torch.utils.flops import count_flops, mfu, peak_flops_per_sec

logger = logging.getLogger(__name__)

BASELINE_RTF = 10.0  # the serving gate of BASELINE.json
# no reference train-throughput number exists, so the training gate is 1x
# realtime: training consumes audio at least as fast as it plays
TRAIN_BASELINE = 1.0
WATCHDOG_S = 900
DEFAULTS = ["experiment=aero_4-16_512_64", "dset=4-16", "precision=bfloat16"]


def _watchdog(metric: str, unit: str, seconds: int = WATCHDOG_S):
    """Print the result line with value 0 and exit 2 if the run has not
    finished after ``seconds``, rather than hang its caller."""
    def on_alarm(_sig, _frame):
        print(json.dumps({"metric": metric, "value": 0, "unit": unit,
                          "vs_baseline": 0,
                          "error": f"no result after {seconds} s "
                                   "(watchdog)"}), flush=True)
        os._exit(2)

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(seconds)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _precision(args) -> str:
    return str(args.get("precision", "float32") or "float32")


def _launches() -> dict:
    """The hand-written kernels' launch counters."""
    from aero_tpu_torch.ops import attention, ftb, lstm

    fn = attention.local_attention
    return {"attention_fwd": fn.launches,
            "attention_bwd": fn.backward_launches,
            "lstm": lstm.lstm_recurrence.launches,
            "ftb": ftb.ftb_tail.launches}


def _counted(fn, *args):
    """``count_flops(fn, *args)``, logging the kernel launches of that
    call as one JSON line on stderr."""
    before = _launches()
    fc = count_flops(fn, *args)
    logger.info("launches of the counted call: %s", json.dumps(
        {k: v - before[k] for k, v in _launches().items()}))
    return fc


def bench_serving(args, device) -> dict:
    batch = int(os.environ.get("AERO_BENCH_BATCH", 16))
    iters = int(os.environ.get("AERO_BENCH_ITERS", 5))
    pipelined = os.environ.get("AERO_BENCH_PIPELINED", "1") == "1"
    exp = args.experiment
    gen = build.build_models(args, device)["generator"].eval()
    chunk = int(int(exp.lr_sr) * SEGMENT_DURATION_SEC)
    x = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (batch, 1, chunk))).astype(np.float32)).to(device)

    @torch.inference_mode()
    def forward(lr):
        return gen(lr)

    acc = float(forward(x).sum())  # warm-up, fetched
    xs = [x * (1.0 + 0.01 * (i + 1)) for i in range(iters)]
    _sync(device)
    if pipelined:
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs = [forward(xi) for xi in xs]
            acc += float(torch.stack([o.sum() for o in outs]).sum())
            reps.append((time.perf_counter() - t0) / iters)
        dt = min(reps)
    else:
        times = []
        for xi in xs:
            t0 = time.perf_counter()
            acc += float(forward(xi).sum())
            times.append(time.perf_counter() - t0)
        dt = statistics.median(times)
    if not np.isfinite(acc):
        raise FloatingPointError(f"serving output not finite: {acc}")
    rtf = batch * SEGMENT_DURATION_SEC / dt
    fc = _counted(forward, x)
    peak = peak_flops_per_sec(device, _precision(args))
    fwd_mfu = mfu(fc.total, dt, peak)
    logger.info("serving: %.3f ms per batch of %d, FLOPs %s", dt * 1e3,
                batch, dict(fc))
    return {
        "metric": "realtime_factor",
        "value": round(rtf, 2),
        "unit": "audio_sec_per_sec",
        "vs_baseline": round(rtf / BASELINE_RTF, 3),
        "mode": "pipelined" if pipelined else "latency",
        "model_tflops": round(fc.total / 1e12, 4),
        "mfu": round(fwd_mfu, 4) if fwd_mfu is not None else None,
        "peak_tflops": round(peak / 1e12, 1) if peak else None,
        "peak_dtype": "bf16",
    }


def bench_train(args, device) -> dict:
    from aero_tpu_torch.train.train_step import TrainStep

    batch = int(os.environ.get("AERO_BENCH_BATCH", 16))
    iters = int(os.environ.get("AERO_BENCH_ITERS", 8))
    world, rank = mesh.world_size(), mesh.rank()
    if batch % world:
        raise ValueError(f"AERO_BENCH_BATCH={batch} does not split over "
                         f"{world} ranks")
    exp = args.experiment
    lr_shape, hr_shape = build.segment_shapes(exp)
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal((batch,) + lr_shape[1:])).astype(
        np.float32)
    hr = (0.1 * rng.standard_normal((batch,) + hr_shape[1:])).astype(
        np.float32)
    rows = slice(rank * batch // world, (rank + 1) * batch // world)
    lr, hr = (torch.from_numpy(a[rows]).to(device) for a in (lr, hr))
    step = TrainStep(args, build.build_models(args, device), device)

    metrics = step(lr, hr)  # warm-up
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = step(lr, hr)
        acc = float(metrics["total"])
        reps.append((time.perf_counter() - t0) / iters)
    if not np.isfinite(acc):
        raise FloatingPointError(f"train step total not finite: {acc}")
    dt = statistics.median(reps)
    # one step on this rank's rows; the ranks' shares are equal, so the
    # global step is world times that, against world cards' peak
    fc = _counted(step, lr, hr)
    total = fc.total * world
    peak = peak_flops_per_sec(device, _precision(args))
    step_mfu = mfu(total, dt, peak * world if peak else None)
    logger.info("train: %.3f ms per step of %d on %d rank(s), FLOPs of "
                "one rank's step %s", dt * 1e3, batch, world, dict(fc))
    aud = batch * float(exp.segment)
    return {
        "metric": "train_throughput",
        "value": round(aud / dt, 2),
        "unit": "audio_sec_trained_per_sec",
        "vs_baseline": round(aud / dt / TRAIN_BASELINE, 3),
        "mode": "chained",
        "step_ms": round(dt * 1e3, 1),
        "batch": batch,
        "model_tflops": round(total / 1e12, 4),
        "mfu": round(step_mfu, 4) if step_mfu is not None else None,
        "devices": world,
        "peak_tflops": round(peak * world / 1e12, 1) if peak else None,
        "peak_dtype": "bf16",
    }


def main(argv=None) -> dict:
    from aero_tpu_torch.utils.config import load_config  # needs PyYAML

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(message)s")
    train = os.environ.get("AERO_BENCH_TRAIN", "0") == "1"
    if train:
        _watchdog("train_throughput", "audio_sec_trained_per_sec")
    else:
        _watchdog("realtime_factor", "audio_sec_per_sec")
    overrides = [a for a in (sys.argv[1:] if argv is None else argv)
                 if "=" in a]
    args = load_config(str(CONF_DIR), "main_config", DEFAULTS + overrides)
    device = resolve_device(args.get("device"))
    if train and mesh.launched():
        device = mesh.init_distributed(device)
    rank = mesh.rank()
    try:
        result = (bench_train if train else bench_serving)(args, device)
    finally:
        mesh.destroy()
    signal.alarm(0)
    if rank == 0:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
