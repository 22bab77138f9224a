"""Tracing, step timing and numerics debugging (port of
``aero_tpu/utils/profiling.py``).

- ``trace(logdir)``          - ``torch.profiler`` over a code region, CPU and
                                CUDA activities, written into ``logdir`` as a
                                Chrome trace (``*.pt.trace.json``)
- ``annotate(name)``         - a named range in that trace
- ``StepTimer``              - per-step wall time with warm-up skip and EMA
- ``enable_nan_debugging()`` - ``torch.autograd.set_detect_anomaly``: the
                                backward raises where a NaN appears (opt-in,
                                the train CLI's ``debug_nans=true``, as in
                                the JAX package: it slows every step)
- ``checkify_step(fn)``      - ``fn`` returning ``(err, out)``, where
                                ``err.throw()`` raises on a non-finite float
                                in ``out`` (the float check that JAX's
                                ``checkify.float_checks`` makes)
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import time

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str = "profile"):
    """Capture a trace: ``with trace('profile/'): step(...)``. The CUDA
    activity is traced when a GPU is present; the trace file's path is
    logged."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}"
                                ".pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per-step timing with warmup skip and EMA."""

    def __init__(self, warmup: int = 2, ema: float = 0.9):
        self.warmup = warmup
        self.ema = ema
        self.count = 0
        self.avg = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.avg = dt if self.avg is None else \
                self.ema * self.avg + (1 - self.ema) * dt
        return False

    @property
    def steps_per_sec(self):
        return 1.0 / self.avg if self.avg else 0.0


def enable_nan_debugging(enabled: bool = True):
    """Raise in the backward where a NaN appears (``enabled``), for the rest
    of the process; used as a context manager, only inside its block."""
    return torch.autograd.set_detect_anomaly(enabled)


class FloatCheckError:
    """The error of a ``checkify_step`` call: ``throw()`` raises if ``out``
    held a non-finite float."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def _non_finite(tree, path="out"):
    """The path of the first floating tensor in ``tree`` (tensors, numbers,
    lists, tuples, dicts) with a NaN or an infinity, or None."""
    if torch.is_tensor(tree):
        if tree.is_floating_point() or tree.is_complex():
            if not bool(torch.isfinite(tree).all()):
                return path
        return None
    if isinstance(tree, float):
        return None if math.isfinite(tree) else path
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return None
    for k, v in items:
        found = _non_finite(v, f"{path}[{k!r}]")
        if found:
            return found
    return None


def checkify_step(fn):
    """``fn`` wrapped to return ``(err, out)``; ``err.throw()`` raises on a
    NaN or an infinity in any float of ``out``."""
    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = _non_finite(out)
        return FloatCheckError(
            None if bad is None else f"non-finite value in {bad}"), out
    return checked
