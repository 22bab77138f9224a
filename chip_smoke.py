#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one GPU and check it.

Run from the repository root, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is not 0):

1. the card: its name and power limit from nvidia-smi; no CUDA -> fail;
2. build the CUDA kernels from aero_tpu_torch/csrc with nvcc (sm_90a);
3. the LocalState attention kernel against its plain PyTorch version at
   head widths 12 and 24, T = 500 .. 6891, and at the serving path's own
   shapes; float32 (TF32 off) to atol 1e-3, bfloat16 to atol 3e-2;
4. the canonical aero_4-16_512_64 generator from the seeded init in
   bfloat16, saved as a reference .th and loaded back as the CLI loads it:
   one forward at batch 16 x 10 s that must launch the kernel 4 times, the
   kernel-vs-plain gap of the whole forward on one chunk in float32 and
   bfloat16, and the predict CLI on a 35 s file;
5. numbers: the realtime factor at batch 16, the kernel's and the plain
   version's times at the enc2/enc3 shapes, a per-layer time breakdown
   and the device's idle share of one batch-16 forward.

The last lines are the kernels' JSON, the card's name and power limit,
and the result JSON.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

LR_SR, HR_SR, SECONDS, BATCH = 4000, 16000, 10, 16
F32_ATOL, BF16_ATOL = 1e-3, 3e-2
GAP_BF16, GAP_F32 = 2e-2, 1e-3  # relative L2, whole forward, kernel vs plain
# LocalState attention at the serving shapes: [B*F, T, heads, C'] per site
ENC2 = (BATCH * 8, 2501, 4, 12)
ENC3 = (BATCH * 4, 2501, 4, 24)


def log(msg):
    print(msg, flush=True)


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    log(f"card: {smi} | torch: {torch.cuda.get_device_name(0)} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def attn_inputs(shape, dtype, seed):
    b, t, h, c = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, c, generator=g) / c ** 0.5
    k = torch.randn(b, t, h, c, generator=g)
    v = torch.randn(b, t, h, c, generator=g)
    # decay slopes from 1e-4 (near-global attention) to 0.1 (local)
    w = 10.0 ** (-4.0 + 3.0 * torch.rand(b, t, h, generator=g))
    return [x.to(dtype).cuda() for x in (q, k, v, w)]


def check_kernel(attention) -> float:
    """Every case within its tolerance; returns the max error at the
    serving path's shapes (bfloat16)."""
    cases = [((2, t, 2, c), dt) for dt in (torch.float32, torch.bfloat16)
             for c in (12, 24) for t in (500, 2501, 3000, 4097, 6891)]
    cases += [(ENC2, torch.bfloat16), (ENC3, torch.bfloat16)]
    serving_err = 0.0
    for i, (shape, dtype) in enumerate(cases):
        xs = attn_inputs(shape, dtype, seed=i)
        got = attention.local_attention(*xs)
        torch.cuda.synchronize()
        want = attention.reference_attention(*xs)
        err = (got.float() - want.float()).abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        log(f"  kernel vs plain {str(dtype)[6:]:8s} [B,T,H,C']={shape}: "
            f"max abs err {err:.3e} (atol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"kernel disagrees with plain at {shape} "
                                 f"{dtype}: {err} > {tol}")
        if shape in (ENC2, ENC3):
            serving_err = max(serving_err, err)
    return serving_err


def forward_with(attention, attn_fn, fwd, x):
    """One forward with LocalState's attention swapped for ``attn_fn``."""
    kernel = attention.local_attention
    attention.local_attention = attn_fn
    try:
        return fwd(x)
    finally:
        attention.local_attention = kernel


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def time_ms(fn, args, n) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def write_test_wav(path, seconds):
    """A 4 kHz chirp with harmonics and a little noise, from a seed."""
    from aero_tpu.data import audio_io

    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * LR_SR)) / LR_SR
    f0 = 120.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / LR_SR
    x = sum(0.2 / k * np.sin(k * phase) for k in range(1, 8))
    audio_io.save(path, (x + 0.01 * rng.standard_normal(t.shape))[None],
                  LR_SR)
    return t.size


def profile_forward(gen, fwd, x, smi):
    """Per-layer device time (CUDA events around modules) and the device's
    busy share of one forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from aero_tpu_torch.models import modules as M

    spans = {}

    def watch(name, module):
        def pre(_m, _a):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.setdefault(name, []).append([ev, None])

        def post(_m, _a, _o):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[name][-1][1] = ev
        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]

    hooks = []
    for i, enc in enumerate(gen.encoder):
        hooks += watch(f"enc{i}", enc)
        for sub in ("freq_attn_block", "dconv"):
            if getattr(enc, sub) is not None:
                hooks += watch(f"enc{i}.{sub}", getattr(enc, sub))
        for m in enc.modules():
            if isinstance(m, (M.BLSTM, M.LocalState)):
                hooks += watch(f"enc{i}.{type(m).__name__}", m)
    for j, dec in enumerate(gen.decoder):
        hooks += watch(f"dec{j}", dec)
    t0 = time.perf_counter()
    fwd(x)
    wall = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    log(f"per-layer device time, one forward B={BATCH} bf16 "
        f"(wall {wall * 1e3:.1f} ms) [{smi}]:")
    for name, pairs in spans.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        log(f"  {name:28s} {ms:9.3f} ms  ({len(pairs)} calls)")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd(x)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"profiled forward: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")


def main():
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aero_tpu_torch import predict
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)
    from aero_tpu_torch.ops import _build, attention
    from aero_tpu_torch.train.from_jax import (
        load_reference_checkpoint, save_reference_checkpoint)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")
    for line in _build.build_log.splitlines():
        if "registers" in line:
            log("  ptxas:" + line.split(":", 1)[1])

    # 3. kernel against plain
    max_err = check_kernel(attention)

    # 4. main path
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "checkpoint.th")
        seeded = build_generator(CANONICAL_AERO_4_16, "bfloat16", "cuda",
                                 seed=0)
        save_reference_checkpoint(ckpt, seeded, CANONICAL_AERO_4_16)
        state, kwargs = load_reference_checkpoint(ckpt)
        gen = build_generator(kwargs, "bfloat16", "cuda", seed=1)
        gen.load_state_dict(state, strict=True)
        if not all(torch.equal(a, b) for a, b in
                   zip(seeded.state_dict().values(),
                       gen.state_dict().values())):
            raise AssertionError("checkpoint round trip changed the weights")
        del seeded
        n_params = sum(p.numel() for p in gen.parameters())
        log(f"generator: canonical aero_4-16_512_64, {n_params} params, "
            f"bf16 compute, loaded from a reference .th")

        rng = np.random.default_rng(0)
        x = (0.1 * rng.standard_normal((BATCH, 1, SECONDS * LR_SR))).astype(
            np.float32)
        fwd = EvalForward(gen, scale=HR_SR / LR_SR, lr_sr=LR_SR,
                          device="cuda")
        attention.local_attention.launches = 0
        y = fwd(x)
        launches = attention.local_attention.launches
        log(f"forward B={BATCH} x {SECONDS} s: out {y.shape}, "
            f"attention kernel launches {launches}")
        if y.shape != (BATCH, 1, SECONDS * HR_SR) or not np.isfinite(y).all():
            raise AssertionError(f"bad output: {y.shape}, finite "
                                 f"{np.isfinite(y).all()}")
        if launches != 4:
            raise AssertionError(f"expected 4 attention launches, {launches}")

        chunk = x[:1]
        gap_bf16 = rel_l2(fwd(chunk), forward_with(
            attention, attention.reference_attention, fwd, chunk))
        gen32 = build_generator(kwargs, "float32", "cuda")
        gen32.load_state_dict(state, strict=True)
        fwd32 = EvalForward(gen32, scale=HR_SR / LR_SR, lr_sr=LR_SR,
                            device="cuda")
        y32 = fwd32(chunk)
        gap_f32 = rel_l2(y32, forward_with(
            attention, attention.reference_attention, fwd32, chunk))
        gap_dtype = rel_l2(fwd(chunk), y32)
        del gen32, fwd32
        log(f"one chunk, kernel vs plain attention, relative L2: "
            f"bf16 {gap_bf16:.3e} (< {GAP_BF16:g}), f32 {gap_f32:.3e} "
            f"(< {GAP_F32:g}); bf16 vs f32 forward {gap_dtype:.3e}")
        if not (gap_bf16 < GAP_BF16 and gap_f32 < GAP_F32):
            raise AssertionError("kernel forward disagrees with plain")

        wav = os.path.join(tmp, "chirp35.wav")
        n_in = write_test_wav(wav, 35)
        try:
            import yaml  # noqa: F401  the CLI's config loader needs it
            out = predict.main([
                "experiment=aero_4-16_512_64", "dset=4-16",
                f"+filename={wav}", f"+output={tmp}/out",
                f"checkpoint_file={ckpt}", "precision=bfloat16",
                "device=cuda"])
            how = "predict CLI (main)"
        except ImportError:
            out = predict.predict_file(gen, wav, f"{tmp}/out", LR_SR, HR_SR,
                                       "cuda")
            how = "predict_file (no PyYAML)"
        log(f"{how}: 35 s file, {n_in} -> {out['out_samples']} samples, "
            f"realtime factor {out['realtime_factor']:.1f}x")
        if out["out_samples"] != 4 * n_in:
            raise AssertionError("predict output is not 4x the input")

    # 5. numbers
    for _ in range(2):
        fwd(x)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fwd(x)
        runs.append(time.perf_counter() - t0)
    med = statistics.median(runs)
    log(f"realtime factor B={BATCH} bf16 {SECONDS} s chunks: "
        f"{BATCH * SECONDS / med:.1f}x (median of {len(runs)}: "
        f"{med * 1e3:.1f} ms per batch, host to host) [{smi}]")

    per_forward = {"kernel": 0.0, "plain": 0.0}
    for name, shape in (("enc2", ENC2), ("enc3", ENC3)):
        xs = attn_inputs(shape, torch.bfloat16, seed=100)
        ms = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = (attention.local_attention if which == "kernel"
                  else attention.reference_attention)
            ms[which].append(time_ms(fn, xs, 10 if which == "kernel" else 3))
        k_ms, p_ms = (statistics.mean(ms[w]) for w in ("kernel", "plain"))
        per_forward["kernel"] += 2 * k_ms
        per_forward["plain"] += 2 * p_ms
        log(f"attention {name} [B*F,T,H,C']={shape} bf16: kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, kernel "
            f"{'faster' if k_ms < p_ms else 'SLOWER'} x{p_ms / k_ms:.2f} "
            f"[{smi}]")

    profile_forward(gen, fwd, x, smi)

    log(json.dumps({"kernels": [{
        "name": "local_attention_fwd", "route": "cuda",
        "source": "aero_tpu_torch/csrc/local_attention.cu",
        "replaces": "aero_tpu/ops/attention.py:298",
        "launches": launches, "max_abs_err": max_err,
        "ms": per_forward["kernel"], "plain_ms": per_forward["plain"]}]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
