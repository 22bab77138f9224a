"""Training: the program's GAN step ``TrainStep.__call__`` in a closed loop.

Set-up makes a pool of ``pool_batches`` batches of ``batch`` segments of
the traffic's signal at the high rate (consecutive slices of one long
signal, so all rows differ) and their low-rate inputs (the benchmark's
resampler), in host memory; each step copies its batch to the device and
fetches its metrics, as the Solver's loop does. The first
``checked_steps`` steps, on the first batches of the pool, are set-up and
the comparison's: after the window the plain reference
(``benchmark/reference``) follows them in float32 from the same weights,
and works out each later step's losses again from the program's weights
before it. Compared: ``loss_gap``, the worst step's losses against the
reference's from the program's weights, and ``change_gap``, the median
leaf's change over the steps. Printed beside them: the losses of the
reference's own steps, and each leaf's first gradient (as the program's
Adam holds it after one step: its first moment / 0.1) and change, by the
worst and the median leaf. The window then draws batches from the pool in
an order from the seed.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch

from benchmark import audio, flops, harness, weights
from benchmark.reference.train import ReferenceStep, segment_lengths

ADAM_B1 = 0.9


def pool(cfg, traffic, seed, device):
    """(lr [P, 1, lr_t], hr [P, 1, hr_t]) float32 numpy."""
    exp = cfg["experiment"]
    lr_t, hr_t = segment_lengths(cfg)
    rows = int(traffic["batch"]) * int(traffic["pool_batches"])
    gen_t = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    hr = audio.SIGNALS[traffic["signal"]](
        gen_t, rows * hr_t / exp["hr_sr"], exp["hr_sr"], device).cpu().numpy()
    lr = audio.resample(hr, exp["hr_sr"], exp["lr_sr"])
    return (np.ascontiguousarray(lr[:rows * lr_t].reshape(rows, 1, lr_t)),
            np.ascontiguousarray(hr[:rows * hr_t].reshape(rows, 1, hr_t)))


def first_grads(opts, params):
    """Each leaf's first gradient from its Adam state after one step (its
    first moment / (1 - beta1)), on the host; zeros where the optimizer
    holds none (it was given nothing)."""
    out = []
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                state = opt.state.get(p, {})
                out.append(state["exp_avg"].float().cpu() / (1 - ADAM_B1)
                           if "exp_avg" in state else
                           torch.zeros(p.shape, dtype=torch.float32))
    return out


def drive(step, gen_params, disc_params, opts, lr, hr, batches, b,
          keep_states=False):
    """Run ``batches`` steps of ``step`` on the pool's first rows; returns
    the readings (and, with ``keep_states``, the weights on the host
    before each step after the first)."""
    params = gen_params + disc_params
    theta = [p.detach().float().clone() for p in params]
    losses, grads, states = [], None, []
    for i in range(batches):
        rows = slice(i * b, (i + 1) * b)
        if keep_states and i:
            states.append([p.detach().float().cpu().clone() for p in params])
        m = step(lr[rows], hr[rows])
        losses.append([float(m["total"]), float(m["discriminator"])])
        if i == 0:
            grads = first_grads(opts, params)
    return {"losses": losses, "grad": grads, "states": states,
            "change": [(p.detach().float() - p0).cpu()
                       for p, p0 in zip(params, theta)]}


class _Named:
    """The program's step with the reference's metric names."""

    def __init__(self, step):
        self.step = step

    def __call__(self, lr, hr):
        m = self.step(lr, hr)
        return {"total": m["total"],
                "discriminator": m["discriminator_msd_melgan"]}


def run(ctx) -> dict:
    from aero_tpu_torch.train.train_step import TrainStep

    cfg, traffic, device, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    b = int(traffic["batch"])
    checked = int(traffic["checked_steps"])
    seg_s = float(cfg["experiment"]["segment"])
    lr, hr = pool(cfg, traffic, seed, device)
    n_batches = lr.shape[0] // b

    reference = weights.seeded_reference(cfg, seed, device)
    models = ctx.make_program(cfg, reference, device, True)
    del reference
    step = TrainStep(harness.port_args(cfg), models, device)
    opts = [step.gen_opt, step.disc_opt]
    program = drive(_Named(step), step.gen_params, step.disc_params, opts,
                    lr, hr, checked, b, keep_states=True)
    step_flops = harness.cached_flops(
        cfg, f"train:{b}", lambda: flops.train_flops(cfg, b))
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
        (more, _, _, failed_b), trace = harness.profiled(
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


def leaf_gaps(got, want, kept):
    """Per leaf, |got - want| / max(want, the median kept leaf's want);
    -1 where a leaf is not kept."""
    want, got = np.asarray(want), np.asarray(got)
    gap = np.abs(got - want) / np.maximum(want, np.median(want[kept]))
    return np.where(kept, gap, -1.0)


def _worst(names, gap, key, left_out):
    print(f"largest {key} gaps: " + ", ".join(
        f"{names[i]} {gap[i]:.3g}" for i in np.argsort(-gap)[:3])
        + f"; {left_out} leaves left out", file=sys.stderr)


def _norms(tensors):
    return np.array([float(t.norm()) for t in tensors])


def _diffs(got, want, kept):
    """Per kept leaf, ||got - want|| / max(||want||, the median kept
    leaf's)."""
    n_want = _norms(want)
    floor = np.median(n_want[kept])
    return np.array([float((a - b).norm()) / max(n, floor) for a, b, n, k
                     in zip(got, want, n_want, kept) if k])


def compare(program, want, forced, nets):
    """Every reading of the program's first steps against the reference's
    (``forced``: the reference's losses of each step from the program's
    weights before it): ``nets`` is [(leaf names, slice of the leaves)] of
    each network."""
    def gaps(ref):
        return np.abs(np.subtract(program["losses"], ref)) / np.abs(ref)

    read = {"loss_gap": float(gaps(forced).max()),
            "loss1_gap": float(gaps(want["losses"])[0].max()),
            "loss_gap_followed": float(gaps(want["losses"]).max())}
    acc = {"grad": [], "change": [], "grad_diff": []}
    for names, part in nets:
        n_ref = _norms(want["grad"][part])
        # a leaf whose reference gradient is nought to rounding (a conv's
        # bias under a train-mode BatchNorm) has a gradient and a change
        # of round-off alone on either side: left out of every reading
        kept = n_ref >= 1e-3 * np.median(n_ref)
        for key in ("grad", "change"):
            got, ref = program[key][part], want[key][part]
            gap = leaf_gaps(_norms(got), _norms(ref), kept)
            _worst(names, gap, key, int((~kept).sum()))
            acc[key].append(gap[kept])
        acc["grad_diff"].append(_diffs(program["grad"][part],
                                       want["grad"][part], kept))
    acc = {k: np.concatenate(v) for k, v in acc.items()}
    read.update(change_gap=float(np.median(acc["change"])),
                change_gap_worst=float(acc["change"].max()),
                grad_gap_worst=float(acc["grad"].max()),
                grad_diff_median=float(np.median(acc["grad_diff"])))
    return read


# compared; the other readings are printed (PERF.md gives them)
COMPARED = ("loss_gap", "change_gap")


def check(ctx, program, lr, hr, checked, b):
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    models = weights.seeded_reference(ctx.cfg, ctx.seed, ctx.device)
    step = ReferenceStep(ctx.cfg, models)

    def tensor(x):
        return torch.from_numpy(x).to(ctx.device)

    want = drive(lambda lo, hi: step(tensor(lo), tensor(hi)), step.gen_params,
                 step.disc_params, [step.gen_opt, step.disc_opt], lr, hr,
                 checked, b)
    # each later step's losses, by the reference from the program's weights
    # before that step
    forced = [want["losses"][0]]
    for i, state in enumerate(program["states"], 1):
        with torch.no_grad():
            for p, v in zip(step.gen_params + step.disc_params, state):
                p.copy_(v)
        rows = slice(i * b, (i + 1) * b)
        m = step.losses(tensor(lr[rows]), tensor(hr[rows]))
        forced.append([m["total"], m["discriminator"]])
    n_gen = len(step.gen_params)
    read = compare(program, want, forced, [
        ([n for n, _ in step.gen.named_parameters()], slice(0, n_gen)),
        ([n for n, _ in step.disc.named_parameters()], slice(n_gen, None))])
    print(f"reference steps: {time.perf_counter() - t:.1f} s; losses "
          f"program {program['losses']} reference {want['losses']}",
          file=sys.stderr)
    print("readings " + json.dumps(read), file=sys.stderr)
    lim = ctx.limits
    return {name: (read[name], lim[name],
                   bool(np.isfinite(read[name])) and read[name] <= lim[name])
            for name in COMPARED}
