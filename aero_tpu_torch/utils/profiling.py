"""Tracing, counters and numerics debugging (port of
``aero_tpu/utils/profiling.py``).

- ``trace(logdir)``          - ``torch.profiler`` over a code region, CPU and
                                CUDA activities, written into ``logdir`` as a
                                Chrome trace (``*.pt.trace.json``); the log
                                gets the spans' table and the counters'
                                changes
- ``annotate(name)``         - a named range (span) in that trace, entered
                                only while a profiler is active
- ``attribute(events)``      - per span name its count, host time, and the
                                device time and operations it launched
- ``counters()``             - every counter of the program, by dotted name
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

import bisect
import collections
import contextlib
import json
import logging
import math
import os
import time
import typing as tp

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(logdir: str = "profile"):
    """Capture a trace: ``with trace('profile/'): step(...)``. The CUDA
    activity is traced when a GPU is present. The log gets the trace
    file's path, the spans' table (``attribute``) and the counters'
    changes over the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    before = counters()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    after = counters()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}"
                                ".pt.trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")
    spans = attribute(events(prof.profiler.kineto_results.events()))
    logger.info("spans [count, host ms, device ms, launches]: "
                f"{json.dumps(table(spans))}; device ms launched outside "
                f"every span {1e3 * spans['outside_s']:.3f}, with no launch "
                f"in the trace {1e3 * spans['unattributed_s']:.3f}")
    logger.info("counters: " + json.dumps(
        {k: v - before[k] for k, v in after.items() if v != before[k]}))


# what ``annotate`` returns with no profiler active: entering it records
# nothing, and one instance serves every span (it holds no state)
_NO_SPAN = contextlib.nullcontext()
# a span is a range of function scope, which the profiler keeps on the host.
# ``record_function`` opens one of user scope, which the profiler also draws
# on the device's timeline, from the first launch inside it to its last; a
# reading of the trace that counts every CUDA event as the device's work
# would take each span for a kernel that ran all that time.
_Span = torch._C._profiler._RecordFunctionFast
# the names of the program's spans start with one of these
PREFIXES = ("train.", "serve.", "aero.", "hifi.", "loss.")


def annotate(name: str):
    """A named range of the profiler's trace around a block: ``with
    annotate("serve.forward"): ...``. With no profiler active it is a shared
    null context, so a span costs a flag test (a range costs several times
    as much even then) and adds no operator to a FLOP count."""
    if torch._C._autograd._profiler_enabled():
        return _Span(name)
    return _NO_SPAN


class Event(tp.NamedTuple):
    name: str
    on_device: bool
    start_us: float
    end_us: float
    correlation: int       # CUPTI's id: a device op and its launch share it
    user_annotation: bool  # a record_function range (or its device image)


def events(kineto_events) -> tp.List[Event]:
    """The profiler's kineto events (``prof.profiler.kineto_results
    .events()``) as ``Event``s."""
    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
                  (e.start_ns() + e.duration_ns()) / 1e3,
                  e.correlation_id(), e.is_user_annotation())
            for e in kineto_events]


def _union(intervals):
    """Sorted, merged (starts, ends) of [(start, end)]."""
    starts, ends = [], []
    for lo, hi in sorted(intervals):
        if ends and lo <= ends[-1]:
            ends[-1] = max(ends[-1], hi)
        else:
            starts.append(lo)
            ends.append(hi)
    return starts, ends


def attribute(evts: tp.Sequence[Event]) -> dict:
    """The device's work put down to the program's spans: {"spans": {name:
    {"count", "host_s"}}, "device_s": {name: s}, "launches": {name: n},
    "unattributed_s": s, "outside_s": s}.

    A device operation (kernel, copy, set) belongs to every span whose host
    interval holds the start of its launch, the CUDA API call (``cu*``)
    with its correlation id, whatever thread launched it (autograd launches
    the backward from its own thread). Device seconds of operations whose
    launch is not in the trace go to ``unattributed_s``, of those launched
    outside every span to ``outside_s``. The device's images of host ranges
    (user annotations, such as ``Optimizer.step``'s) are no device work."""
    host = [e for e in evts if not e.on_device]
    intervals = collections.defaultdict(list)
    for e in host:
        if e.name.startswith(PREFIXES):
            intervals[e.name].append((e.start_us, e.end_us))
    launch_at = {e.correlation: e.start_us for e in host
                 if e.correlation and e.name.startswith("cu")}
    unions = {name: _union(iv) for name, iv in intervals.items()}
    device_s = dict.fromkeys(intervals, 0.0)
    launches = dict.fromkeys(intervals, 0)
    unattributed = outside = 0.0
    for op in evts:
        if not op.on_device or op.user_annotation:
            continue
        seconds = (op.end_us - op.start_us) / 1e6
        at = launch_at.get(op.correlation)
        if at is None:
            unattributed += seconds
            continue
        inside = False
        for name, (starts, ends) in unions.items():
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= ends[i]:
                device_s[name] += seconds
                launches[name] += 1
                inside = True
        if not inside:
            outside += seconds
    return {
        "spans": {name: {"count": len(iv),
                         "host_s": sum(hi - lo for lo, hi in iv) / 1e6}
                  for name, iv in intervals.items()},
        "device_s": device_s,
        "launches": launches,
        "unattributed_s": unattributed,
        "outside_s": outside,
    }


def table(spans: dict) -> dict:
    """``attribute``'s result as {name: [count, host ms, device ms,
    launches]}."""
    return {name: [s["count"], round(1e3 * s["host_s"], 3),
                   round(1e3 * spans["device_s"][name], 3),
                   spans["launches"][name]]
            for name, s in sorted(spans["spans"].items())}


def counters() -> tp.Dict[str, int]:
    """A snapshot of every counter of the program: {"<owner>.<counter>":
    count}, the kernel wrappers' launch and call counts (GroupNorm's on
    aten's autograd path too), the BLSTM's forwards by route, the serving
    path's samples and forwards, and the spectral norm's power
    iterations."""
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.discriminators import SNConv1d
    from aero_tpu_torch.models.modules import BLSTM
    from aero_tpu_torch.ops.attention import local_attention, \
        periodic_attention
    from aero_tpu_torch.ops.ftb import ftb_tail
    from aero_tpu_torch.ops.group_norm import group_norm
    from aero_tpu_torch.ops.lstm import lstm_recurrence

    owners = {
        "local_attention": (local_attention, (
            "launches", "mma_launches", "banded_launches",
            "backward_launches", "backward_mma_launches")),
        "periodic_attention": (periodic_attention, ("calls",)),
        "lstm_recurrence": (lstm_recurrence, ("launches", "mma_launches")),
        "ftb_tail": (ftb_tail, ("launches", "mma_launches")),
        "group_norm": (group_norm, ("calls", "autograd_calls")),
        "blstm": (BLSTM, ("kernel_forwards", "library_forwards")),
        "EvalForward": (EvalForward, (
            "samples", "padded_samples", "graph_captures", "graph_replays",
            "eager_forwards")),
        "SNConv1d": (SNConv1d, ("power_iterations",)),
    }
    return {f"{name}.{key}": int(getattr(owner, key))
            for name, (owner, keys) in owners.items() for key in keys}


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
