"""Training against HiFi-GAN's discriminators: the program's GAN step
``TrainStep.__call__`` with ``discriminator_models=[hifi]`` (its MSD and
MPD, the LS-GAN, feature and mel losses) in a closed loop.

The loop, the pool, the window and the comparison are ``drivers/train.py``'s
(see there); what differs is the models, their weights
(``benchmark/weights_hifi.py``), the reference (``ReferenceHifiStep`` of
``benchmark/reference/hifi.py``), the FLOP count
(``benchmark/flops_hifi.py``), and the state the comparison follows: every
spectral-normed convolution's stored ``weight_u`` beside the parameters,
so that each later step's losses are worked out again from the program's
full state. Compared: ``loss_gap`` and ``change_gap`` as
``drivers/train.py``'s; ``grad_diff_median``, the median leaf's ||g −
g_ref|| / max(||g_ref||, the median leaf's) of the first gradients; and
``u_gap``, the largest ||Δu − Δu_ref|| over the stored u after the
checked steps. The other readings of ``compare`` are printed.

A traced run also puts the profiled steps' device work down to the
program's spans (``trace["program"]``, ``profiling.attribute``), which the
``mpd_*``, ``msd_*`` and ``mel_*`` metrics read, and prints that table.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import flops_hifi, harness, weights_hifi
from benchmark.drivers.train import compare, drive, pool
from benchmark.reference.hifi import ReferenceHifiStep

DISCS = ("msd_hifi", "mpd")
# compared; the other readings are printed (PERF.md §2 gives them). In
# bfloat16 the losses read as much as float8 does, so the median leaf's
# gradient gap separates the precision; the stored u has its own gap
COMPARED = ("loss_gap", "change_gap", "grad_diff_median", "u_gap")


def program_models(cfg, reference, device, with_disc: bool):
    """The program's generator, MSD and MPD holding the reference models'
    weights (and stored u), in the configuration's precision, on
    ``device``."""
    from aero_tpu_torch.models.discriminators import (
        MultiPeriodDiscriminator, MultiScaleDiscriminator)
    from aero_tpu_torch.models.factory import PRECISIONS

    models = harness.program_models(cfg, reference, device, False)
    if with_disc:
        exp = cfg["experiment"]
        dtype = PRECISIONS[cfg["precision"]]
        with torch.device(device):
            models["msd_hifi"] = MultiScaleDiscriminator(
                **exp["msd"], compute_dtype=dtype)
            models["mpd"] = MultiPeriodDiscriminator(
                **exp["mpd"], compute_dtype=dtype)
        for name in DISCS:
            models[name].load_state_dict(reference[name].state_dict(),
                                         strict=True)
    return models


def stored_u(models):
    """Every stored ``weight_u`` of the discriminators, in module order."""
    return [b for name in DISCS for n, b in models[name].named_buffers()
            if n.endswith("weight_u")]


class _Named:
    """The program's step with the reference's metric names."""

    def __init__(self, step):
        self.step = step

    def __call__(self, lr, hr):
        m = self.step(lr, hr)
        return {"total": m["total"],
                "discriminator": m["discriminator_hifi"]}


def profiled(run, device):
    """``harness.profiled``, with the device work put down to the
    program's spans as ``trace["program"]``."""
    from torch.profiler import ProfilerActivity, profile

    from aero_tpu_torch.utils import profiling

    harness.sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        value = run()
        harness.sync(device)
        wall = time.perf_counter() - t0
    events = profiling.events(prof.profiler.kineto_results.events())
    trace = harness.reduce_trace(
        [(e.name, e.on_device, e.start_us, e.end_us) for e in events], wall)
    trace["program"] = profiling.attribute(events)
    print("spans [count, host ms, device ms, launches]: "
          + json.dumps(profiling.table(trace["program"])), file=sys.stderr)
    return value, trace


def run(ctx) -> dict:
    from aero_tpu_torch.train.train_step import TrainStep

    cfg, traffic, device, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    b = int(traffic["batch"])
    checked = int(traffic["checked_steps"])
    seg_s = float(cfg["experiment"]["segment"])
    lr, hr = pool(cfg, traffic, seed, device)
    n_batches = lr.shape[0] // b

    reference = weights_hifi.seeded_reference(cfg, seed, device)
    make = (program_models if ctx.make_program is harness.program_models
            else ctx.make_program)
    models = make(cfg, reference, device, True)
    del reference
    step = TrainStep(harness.port_args(cfg), models, device)
    opts = [step.gen_opt, step.disc_opt]
    program = drive(_Named(step), step.gen_params,
                    step.disc_params + stored_u(models), opts, lr, hr,
                    checked, b, keep_states=True)
    step_flops = harness.cached_flops(
        cfg, f"train:{b}", lambda: flops_hifi.train_flops(cfg, b))
    order = np.random.default_rng([seed, 4]).integers(
        checked, n_batches, size=harness.MAX_UNITS)

    def unit(i):
        rows = slice(order[i] * b, (order[i] + 1) * b)
        m = step(lr[rows], hr[rows])
        if not all(np.isfinite(v) for v in m.values()):
            raise FloatingPointError(f"step {i}: {m}")
        return m

    unit(0)  # one more step, on a pool batch, before the window
    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"setup_s": harness.process_age_s()}
    trace = None
    if not ctx.trace:
        records, t0, t1, failed = harness.closed_loop(unit, 1, ctx.seconds)
        out["metrics"] = {
            "train_audio_s_per_s": len(records) * b * seg_s / (t1 - t0)}
        ms = np.array([1e3 * (r.end - r.start) for r in records])
        print(f"window {t1 - t0:.3f} s, {len(records)} steps; step ms "
              f"p10 {np.percentile(ms, 10):.2f} median {np.median(ms):.2f} "
              f"p90 {np.percentile(ms, 90):.2f}", file=sys.stderr)
    else:
        records, t0, t1, failed = harness.closed_loop(
            unit, 1, ctx.seconds * harness.TRACED_SHARE)
        first = records[-1].index + 1 if records else 1
        (more, _, _, failed_b), trace = profiled(
            lambda: harness.closed_loop(unit, first,
                                        count=int(traffic["profile_units"])),
            device)
        trace.update(spans={}, flops=len(records) * step_flops,
                     flops_s=t1 - t0, cfg=cfg, steps=len(more), batch=b)
        records += more
        failed += failed_b
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    attempted = len(records) + failed
    del step, models, opts, records
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, program, lr, hr, checked, b)
    out.update(attempted=attempted, failed=failed, checks=checks,
               memory_peak_bytes=peak, trace=trace)
    return out


def check(ctx, program, lr, hr, checked, b):
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = weights_hifi.seeded_reference(ctx.cfg, ctx.seed, ctx.device)
    step = ReferenceHifiStep(ctx.cfg, models)
    state = step.gen_params + step.disc_params + step.us

    def tensor(x):
        return torch.from_numpy(x).to(ctx.device)

    want = drive(lambda lo, hi: step(tensor(lo), tensor(hi)), step.gen_params,
                 step.disc_params + step.us, [step.gen_opt, step.disc_opt],
                 lr, hr, checked, b)
    # each later step's losses, by the reference from the program's state
    # (weights and stored u) before that step
    forced = [want["losses"][0]]
    for i, kept in enumerate(program["states"], 1):
        with torch.no_grad():
            for p, v in zip(state, kept):
                p.copy_(v)
        rows = slice(i * b, (i + 1) * b)
        m = step.losses(tensor(lr[rows]), tensor(hr[rows]))
        forced.append([m["total"], m["discriminator"]])
    n_gen, n_disc = len(step.gen_params), len(step.disc_params)
    disc_names = [f"{name}.{n}" for name in DISCS
                  for n, _ in models[name].named_parameters()]
    read = compare(program, want, forced, [
        ([n for n, _ in step.gen.named_parameters()], slice(0, n_gen)),
        (disc_names, slice(n_gen, n_gen + n_disc))])
    u_from = n_gen + n_disc
    read["u_gap"] = max(
        (float((a - w).norm()) for a, w in zip(program["change"][u_from:],
                                               want["change"][u_from:])),
        default=0.0)
    print(f"reference steps: {time.perf_counter() - t:.1f} s; losses "
          f"program {program['losses']} reference {want['losses']}",
          file=sys.stderr)
    print("readings " + json.dumps(read), file=sys.stderr)
    lim = ctx.limits
    return {name: (read[name], lim[name],
                   bool(np.isfinite(read[name])) and read[name] <= lim[name])
            for name in COMPARED}
