"""What every driver of the benchmark shares: the manifest and the files it
names, the set-up clock, the closed-loop window, the profiled part of a
traced run and its reduction, module spans, and the program's models with
the benchmark's weights."""

from __future__ import annotations

import bisect
import collections
import hashlib
import importlib.util
import json
import os
import sys
import time
import typing as tp
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aero_tpu")
# the units a window may draw (files or steps): more than any window runs
MAX_UNITS = 100000
# the share of a traced run's window measured untraced, for ``mfu.*``; the
# profiled units follow it
TRACED_SHARE = 0.6


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(manifest: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic mix, limits, and the names
    of its end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    layers = [m for m in manifest["per_layer"]
              if workload in m.get("workloads", [workload])
              and m["moves"] in reported]
    return {
        "cell": cell,
        "config": load_json(ROOT / configs[cell["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{workload}.json"),
        "end_to_end": [m["name"] for m in e2e],
        "per_layer": [m["name"] for m in layers],
    }


def load_reader(name: str):
    """The per-layer metric reader ``benchmark/layer_metrics/<name>.py``."""
    path = HERE / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> tp.List[str]:
    """Top-level names of ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --- the program under test ------------------------------------------------

def port_args(cfg):
    """The configuration as the program's config object."""
    from aero_tpu_torch.utils.config import Config

    tree = {k: v for k, v in cfg.items()
            if k not in ("name", "source", "about", "overrides", "reduced")}
    return Config._wrap(tree)


def program_models(cfg, reference, device, with_disc: bool):
    """The program's generator (and MelGAN) holding the reference models'
    weights, in the configuration's precision, built on ``device``."""
    from aero_tpu_torch.models.aero import Aero
    from aero_tpu_torch.models.discriminators import MelganDiscriminator
    from aero_tpu_torch.models.factory import PRECISIONS

    exp = cfg["experiment"]
    dtype = PRECISIONS[cfg["precision"]]
    kw = dict(exp["aero"], strides=tuple(exp["aero"]["strides"]))
    with torch.device(device):
        models = {"generator": Aero(**kw, compute_dtype=dtype)}
        if with_disc:
            models["msd_melgan"] = MelganDiscriminator(
                **exp["melgan_discriminator"], compute_dtype=dtype)
    for name, model in models.items():
        model.load_state_dict(reference[name].state_dict(), strict=True)
    models["generator"].eval()
    return models


# --- the window ------------------------------------------------------------

class Record(tp.NamedTuple):
    index: int
    start: float
    end: float
    value: tp.Any


def closed_loop(unit: tp.Callable[[int], tp.Any], first: int,
                seconds: float = None, count: int = None
                ) -> tp.Tuple[tp.List[Record], float, float, int]:
    """One caller: ``unit(i)`` for i = first, first + 1, ... until
    ``seconds`` have passed (the unit running then completes) or ``count``
    units ran. Returns (records, window start, window end, units that
    raised); the window ends when its last unit completes."""
    records, failed = [], 0
    t0 = time.perf_counter()
    i = first
    while True:
        start = time.perf_counter()
        try:
            value = unit(i)
        except Exception as e:  # a failed request counts; the run goes on
            print(f"unit {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failed += 1
            value = None
        end = time.perf_counter()
        if value is not None:
            records.append(Record(i, start, end, value))
        i += 1
        if count is not None and i - first >= count:
            break
        if seconds is not None and end - t0 >= seconds:
            break
        if failed > 3 and not records:
            break
    return records, t0, time.perf_counter(), failed


# --- spans and the profiled part ----------------------------------------------

class _HostEvent:
    """A CUDA event's interface on the host clock (CPU rehearsals)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class Spans:
    """CUDA events around modules: per group, the device ms of each unit."""

    def __init__(self, groups: tp.Dict[str, tp.List[torch.nn.Module]],
                 device):
        self.event = (lambda: torch.cuda.Event(enable_timing=True)) \
            if torch.device(device).type == "cuda" else _HostEvent
        self.events: tp.Dict[str, list] = {g: [] for g in groups}
        self.hooks = []
        for group, modules in groups.items():
            for m in modules:
                self.hooks += self._watch(group, m)
        self.units: tp.Dict[str, tp.List[list]] = {g: [] for g in groups}

    def _watch(self, group, module):
        def pre(_m, _a):
            ev = self.event()
            ev.record()
            self.events[group].append([ev, None])

        def post(_m, _a, _o):
            ev = self.event()
            ev.record()
            self.events[group][-1][1] = ev

        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]

    def end_unit(self) -> None:
        for group, events in self.events.items():
            self.units[group].append(events)
            self.events[group] = []

    def close(self) -> tp.Dict[str, tp.List[float]]:
        """Remove the hooks; {group: [ms of each unit]} (call after a
        synchronise)."""
        for h in self.hooks:
            h.remove()
        return {g: [sum(a.elapsed_time(b) for a, b in unit) for unit in units]
                for g, units in self.units.items()}


def profiled(run: tp.Callable[[], tp.Any], device):
    """Run ``run()`` under torch.profiler; returns (its value, the reduced
    trace: busy_s, window_s, kernels [(name, seconds)], breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = run()
        sync(device)
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
               (e.start_ns() + e.duration_ns()) / 1e3)
              for e in prof.profiler.kineto_results.events()]
    return value, reduce_trace(events, wall)


def reduce_trace(events, wall: float) -> dict:
    """From (name, on the device, start us, end us) events: busy seconds
    (the union of the device's activity intervals), the device operations
    by total time, and the longest idle gaps named by the innermost host
    operation running at their middle."""
    device = sorted((lo, hi, n) for n, on_device, lo, hi in events
                    if on_device)
    host = sorted((lo, hi, n) for n, on_device, lo, hi in events
                  if not on_device)
    busy_us, end_us, gaps = 0.0, None, []
    for start, end, _ in device:
        if end_us is not None and start > end_us:
            gaps.append((start - end_us, end_us, start))
        busy_us += max(0.0, end - (start if end_us is None
                                   else max(start, end_us)))
        end_us = end if end_us is None else max(end_us, end)
    if host and device and device[0][0] > host[0][0]:
        gaps.append((device[0][0] - host[0][0], host[0][0], device[0][0]))
    by_name = collections.Counter()
    for start, end, name in device:
        by_name[name] += (end - start) / 1e6
    starts = [h[0] for h in host]
    named_gaps = []
    for length, lo, hi in sorted(gaps, reverse=True)[:10]:
        mid = (lo + hi) / 2
        covering = [h for h in host[:bisect.bisect_right(starts, mid)]
                    if h[1] >= mid]
        name = min(covering, key=lambda h: h[1] - h[0])[2] if covering \
            else "host, no profiled op"
        named_gaps.append([name, length / 1e6])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall,
        "kernels": [(name, (end - start) / 1e6) for start, end, name in device],
        "breakdown": {
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": named_gaps,
        },
    }


# --- the FLOP counts of a cell's shapes, cached in the checkout ----------------

CACHE = HERE / ".cache"


def cached_flops(cfg, key: str, compute: tp.Callable[[], int]) -> int:
    """``compute()``, kept under ``benchmark/.cache`` by configuration and
    ``key`` (FLOPs depend on the shapes alone)."""
    digest = hashlib.sha256(json.dumps(cfg, sort_keys=True).encode()
                            ).hexdigest()[:16]
    path = CACHE / f"flops-{digest}.json"
    table = load_json(path) if path.exists() else {}
    if key not in table:
        table[key] = compute()
        CACHE.mkdir(exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(table, sort_keys=True))
        os.replace(tmp, path)
    return int(table[key])
