"""Serving: one caller in a closed loop sends files through the program's
``ChunkedInference(EvalForward(gen, bucket_s), batch_chunks=True)``, as
``aero_tpu_torch.predict.predict_file`` builds it, numpy in and numpy out.

The traffic file gives the signal (``speech`` or ``music``) and the file
durations: ``{"kind": "fixed", "seconds": s}`` or ``{"kind": "lognormal",
"median_s", "sigma", "min_s", "max_s", "block"}``. A lognormal mix is a
fixed set of ``block`` durations (the distribution's quantiles at (i +
0.5) / block, clipped), sent block after block, each block in another
order drawn from the seed: every seed sends the same sizes. Each file is a
slice, at an offset drawn from the seed, of one long signal made at
set-up. After the window a sample of the files, drawn from the seed with
the longest among them, goes through the plain reference
(``benchmark/reference``) in float32, and each output's relative L2 gap to
it is held to the cell's limit.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import audio, flops, harness, weights
from benchmark.reference import serve as ref_serve


def durations(traffic, seed: int, sr: int, count: int) -> np.ndarray:
    """Samples of the first ``count`` files."""
    d = traffic["durations"]
    if d["kind"] == "fixed":
        return np.full(count, int(round(d["seconds"] * sr)))
    nd = statistics.NormalDist(math.log(d["median_s"]), d["sigma"])
    block = np.clip([math.exp(nd.inv_cdf((i + 0.5) / d["block"]))
                     for i in range(d["block"])], d["min_s"], d["max_s"])
    block = np.round(block * sr).astype(np.int64)
    rng = np.random.default_rng([seed, 1])
    blocks = [rng.permutation(block) for _ in range(-(-count // len(block)))]
    return np.concatenate(blocks)[:count]


def shapes(lengths, sr: int, chunk_s: float, bucket_s: float):
    """The distinct forwards (rows, input samples) that files of these
    lengths make through the chunked path."""
    chunk, bucket = int(sr * chunk_s), int(sr * bucket_s)
    out = set()
    for t in set(int(t) for t in lengths):
        for rows, n in forwards(t, chunk, bucket):
            out.add((rows, n))
    return sorted(out)


def forwards(t: int, chunk: int, bucket: int):
    """(rows, padded samples) of each forward of one file of t samples."""
    def pad(n):
        return max(bucket, -(-n // bucket) * bucket)
    if t <= chunk:
        return [(1, pad(t))]
    n_full = t // chunk
    out = [(n_full, chunk)]
    if t > n_full * chunk:
        out.append((1, pad(t - n_full * chunk)))
    return out


def run(ctx) -> dict:
    from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward

    cfg, traffic, device, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    exp = cfg["experiment"]
    sr, scale = int(exp["lr_sr"]), exp["hr_sr"] / exp["lr_sr"]
    chunk_s, bucket_s = float(traffic["chunk_s"]), float(cfg["eval_bucket_s"])
    chunk, bucket = int(sr * chunk_s), int(sr * bucket_s)

    plan = durations(traffic, seed, sr, harness.MAX_UNITS)
    gen_t = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    signal = audio.SIGNALS[traffic["signal"]](
        gen_t, float(traffic["signal_s"]), sr, device).cpu().numpy()
    offsets = np.random.default_rng([seed, 2]).integers(
        0, signal.size - plan + 1)

    reference = weights.seeded_reference(cfg, seed, device)
    gen = ctx.make_program(cfg, reference, device, False)["generator"]
    del reference
    forward = EvalForward(gen, scale=scale, lr_sr=sr, device=device,
                          bucket_s=bucket_s)
    chunked = ChunkedInference(forward, sr, segment_s=chunk_s,
                               batch_chunks=bool(cfg["batch_chunks"]))
    needed = shapes(plan, sr, chunk_s, bucket_s)
    for rows, n in needed:  # warm every shape the traffic makes, twice
        x = np.repeat(signal[None, None, :n], rows, axis=0)
        for _ in range(2):
            forward(x)
    per_row = {n: harness.cached_flops(
        cfg, f"serve:1x{n}", lambda n=n: flops.serve_flops(cfg, 1, n))
        for n in sorted({n for _, n in needed})}

    def file_flops(t):
        return sum(rows * per_row[n] for rows, n in forwards(t, chunk, bucket))

    def unit(i):
        x = signal[offsets[i]:offsets[i] + plan[i]][None, None]
        return chunked(x)

    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = {"setup_s": harness.process_age_s()}
    trace = None
    if not ctx.trace:
        records, t0, t1, failed = harness.closed_loop(unit, 0, ctx.seconds)
        audio_s = sum(plan[r.index] for r in records) / sr
        lat = [1e3 * (r.end - r.start) for r in records]
        out["metrics"] = {
            "serve_rtf": audio_s / (t1 - t0),
            "file_p95_ms": float(np.percentile(lat, 95)) if lat else None}
        print(f"window {t1 - t0:.3f} s, {len(records)} files, latency "
              f"median {statistics.median(lat) if lat else 0:.3f} ms, p95 "
              f"{out['metrics']['file_p95_ms']} ms", file=sys.stderr)
    else:
        records, t0, t1, failed = harness.closed_loop(
            unit, 0, ctx.seconds * harness.TRACED_SHARE)
        rate = (sum(file_flops(plan[r.index]) for r in records), t1 - t0)
        spans = harness.Spans({name: reader.modules(gen)
                               for name, reader in ctx.readers.items()
                               if hasattr(reader, "modules")}, device)

        def traced_unit(i):
            y = unit(i)
            spans.end_unit()
            return y

        first = records[-1].index + 1 if records else 0
        (more, _, _, failed_b), trace = harness.profiled(
            lambda: harness.closed_loop(traced_unit, first,
                                        count=int(traffic["profile_units"])),
            device)
        trace.update(
            spans=spans.close(), flops=rate[0], flops_s=rate[1], cfg=cfg,
            forwards=[f for r in more for f in forwards(plan[r.index], chunk,
                                                        bucket)])
        records += more
        failed += failed_b
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0

    del chunked, forward, gen
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(ctx, records, plan, offsets, signal, sr, scale, chunk_s,
                   bucket_s)
    out.update(attempted=len(records) + failed, failed=failed, checks=checks,
               memory_peak_bytes=peak, trace=trace)
    return out


def check(ctx, records, plan, offsets, signal, sr, scale, chunk_s, bucket_s):
    """Relative L2 gap of sampled outputs to the float32 reference."""
    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = weights.seeded_reference(ctx.cfg, ctx.seed,
                                   ctx.device)["generator"].eval()
    done = {r.index: r.value for r in records}
    rng = np.random.default_rng([ctx.seed, 3])
    k = min(int(ctx.traffic["compare"]), len(done))
    sample = set(rng.choice(sorted(done), size=k, replace=False).tolist()) \
        if k else set()
    if done:
        sample.add(max(done, key=lambda i: (plan[i], -i)))
    worst, shape_ok = 0.0, True
    for i in sorted(sample):
        x = signal[offsets[i]:offsets[i] + plan[i]][None, None]
        want = ref_serve.predict(ref, x, sr, scale, ctx.device, chunk_s,
                                 bucket_s)
        got = np.asarray(done[i])
        if got.shape != want.shape or not np.isfinite(got).all():
            shape_ok = False
            continue
        gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst = max(worst, gap)
    print(f"reference over {len(sample)} files: {time.perf_counter() - t:.1f}"
          f" s", file=sys.stderr)
    lim = ctx.limits["rel_l2"]
    return {"rel_l2": (worst, lim, worst <= lim and shape_ok and bool(sample)),
            "files_checked": (len(sample), 1, bool(sample)),
            "shapes_finite": (int(shape_ok), 1, shape_ok)}
