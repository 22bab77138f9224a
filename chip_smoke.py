#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

Run from the repository root, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is not 0):

1. the card: its name and power limit from nvidia-smi; no CUDA -> fail;
2. build the CUDA kernels from aero_tpu_torch/csrc with nvcc (sm_90a, one
   nvcc per source, all at once) and print each kernel's registers and
   spills;
3. the LocalState attention forward kernel against its plain PyTorch
   version at head widths 12 and 24, T = 500 .. 6891, and at the serving
   and train shapes; float32 (TF32 off) to atol 1e-3, bfloat16 to 3e-2;
4. the backward kernels through ``torch.autograd.grad`` of
   ``local_attention`` against ``reference_attention_bwd`` (dq, dk, dv, dw
   within tol * max|want|: 1e-4 in float32, 2e-2 in bfloat16) and the
   forward's log-sum-exp against ``logsumexp`` of the plain scores, at
   T = 501 .. 4097 and at the train shapes;
5. serving: the canonical aero_4-16_512_64 generator from the seeded init
   in bfloat16, saved as a reference .th and loaded back as the CLI loads
   it: one forward at batch 16 x 10 s that must launch the forward kernel 4
   times, the kernel-vs-plain gap of the whole forward on one chunk in
   float32 and bfloat16, and the predict CLI on a 35 s file;
6. training: the canonical generator and MelGAN discriminator from the
   seeded init. At batch 4, one step's losses, generator gradient and each
   LocalState gradient leaf with the kernels against the same step with
   the plain attention under autograd, in float32 and bfloat16. Then
   bfloat16 at batch 16 x 2 s with bench.py's batch: 4 forward kernel
   launches and 4 backward calls of 2 kernels each per step,
   finite metrics, both networks' weights changed, the median step time
   of 5 after 2 warm-ups, throughput, peak memory, and a profiled step's
   top kernels and idle share;
7. numbers: the realtime factor at batch 16 with a per-layer breakdown and
   idle share of one forward; per attention call at the train and serving
   shapes, the forward and backward kernels' times against their plain
   versions, the library call (scaled_dot_product_attention with a float
   bias) and the bound.

The last lines are the kernels' JSON, the card's name and power limit,
and the result JSON.
"""

from __future__ import annotations

import json
import math
import os
import re
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
# ... and at the train step's, B = 16 x 2 s (T = 8000 / 16 + 1)
TRAIN_ENC2 = (BATCH * 8, 501, 4, 12)
TRAIN_ENC3 = (BATCH * 4, 501, 4, 24)
# backward: max|got - want| <= tol * max|want| per gradient
BWD_TOL_F32, BWD_TOL_BF16 = 1e-4, 2e-2
LSE_ATOL = 1e-3  # float32 log-sum-exp of scores of size O(10)
# train step at batch 4, kernels vs plain attention: relative gap of each
# loss, relative L2 gap of the flattened generator gradient
TRAIN_LOSS_GAP = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TRAIN_GRAD_GAP = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# ... and relative L2 gap of each LocalState gradient leaf. A backward that
# returns zeros, or a transposed dw, gives about 1. float32 holds it
# tightly (measured <= 4.0e-5); in bfloat16 the two runs' roundings differ
# across the whole network, and the decay leaves, sums with cancellation,
# read up to 0.18 (H100), so bfloat16 only catches a gross fault
TRAIN_ATTN_LEAF_GAP = {torch.float32: 1e-3, torch.bfloat16: 0.5}
# H100 SXM peaks (data sheet, dense, at 700 W): bf16 tensor FLOP/s, HBM B/s
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conf")


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


def print_ptxas(build_log: str):
    """One line per kernel instance (name<dtype, width>): registers, shared
    memory and spills, from nvcc -Xptxas=-v."""
    name, spill = "?", ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(local_attention_[a-z_]+_kernel)"
                          r"I(f|13__nv_bfloat16)Li(\d+)E", line)
            name = (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'}, {m[3]}>"
                    if m else line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")


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
    serving and train paths' shapes (bfloat16)."""
    cases = [((2, t, 2, c), dt) for dt in (torch.float32, torch.bfloat16)
             for c in (12, 24) for t in (500, 2501, 3000, 4097, 6891)]
    path_shapes = (ENC2, ENC3, TRAIN_ENC2, TRAIN_ENC3)
    cases += [(s, torch.bfloat16) for s in path_shapes]
    path_err = 0.0
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
        if shape in path_shapes:
            path_err = max(path_err, err)
    return path_err


def check_backward(attention):
    """The backward through autograd against ``reference_attention_bwd``
    and the forward's log-sum-exp against ``logsumexp`` of the plain
    scores, at every case: ``torch.autograd.grad`` of ``local_attention``
    must launch the forward kernel once and both backward kernels, and
    hold dq, dk, dv and dw. Returns (max abs error, max error / max|want|)
    over the train shapes' gradients (bfloat16)."""
    cases = [((2, t, 2, c), dt) for dt in (torch.float32, torch.bfloat16)
             for c in (12, 24) for t in (501, 762, 1379, 2048, 2501, 4097)]
    cases += [(TRAIN_ENC2, torch.bfloat16), (TRAIN_ENC3, torch.bfloat16)]
    train_abs = train_rel = 0.0
    fn = attention.local_attention
    for i, (shape, dtype) in enumerate(cases):
        xs = [x.requires_grad_() for x in
              attn_inputs(shape, dtype, seed=1000 + i)]
        b, t, h, c = shape
        g = torch.randn(b, t, h, c, device="cuda").to(dtype)
        before = (fn.launches, fn.backward_launches)
        out = fn(*xs)
        got = torch.autograd.grad(out, xs, g)
        torch.cuda.synchronize()
        launched = (fn.launches - before[0], fn.backward_launches - before[1])
        if launched != (1, 2):
            raise AssertionError(f"autograd at {shape} launched {launched} "
                                 "forward and backward kernels, not (1, 2)")
        q, k, v, w = (x.detach() for x in xs)
        want = attention.reference_attention_bwd(q, k, v, w, out.detach(), g)
        tol = BWD_TOL_F32 if dtype == torch.float32 else BWD_TOL_BF16
        errs = []
        for name, a, e in zip(("dq", "dk", "dv", "dw"), got, want):
            if a.shape != e.shape or a.dtype != e.dtype:
                raise AssertionError(f"backward {name} at {shape}: "
                                     f"{a.shape} {a.dtype}, want {e.shape} "
                                     f"{e.dtype}")
            err = (a.float() - e.float()).abs().max().item()
            scale = e.float().abs().max().item()
            errs.append((err, err / scale))
            if not err <= tol * scale:
                raise AssertionError(f"backward {name} at {shape} {dtype}: "
                                     f"{err} > {tol} * {scale}")
        fold = [attention._fold(x, b, t, h, c) for x in (q, k, v)]
        _, lse = attention._kernel_fwd(*fold, attention._fold_w(w, b, t, h),
                                       with_lse=True)
        with torch.no_grad():
            t_idx = torch.arange(t, device="cuda", dtype=torch.float32)
            scores = [attention._scores(
                q.float(), k.float(), w.float().permute(0, 2, 1), t_idx,
                s0, min(s0 + 256, t))[0] for s0 in range(0, t, 256)]
            want_lse = torch.cat([sc.logsumexp(2) for sc in scores], dim=2)
        lse_err = (lse.view(b, h, t) - want_lse).abs().max().item()
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"lse at {shape} {dtype}: {lse_err}")
        log(f"  backward vs plain {str(dtype)[6:]:8s} [B,T,H,C']={shape}: "
            + " ".join(f"{n} {e:.2e} ({r:.1e} of max)" for n, (e, r) in
                       zip(("dq", "dk", "dv", "dw"), errs))
            + f"; tol {tol:g} of max; lse {lse_err:.2e}")
        if shape in (TRAIN_ENC2, TRAIN_ENC3):
            train_abs = max([train_abs] + [e for e, _ in errs])
            train_rel = max([train_rel] + [r for _, r in errs])
    return train_abs, train_rel


def forward_with(attention, attn_fn, fn, *args):
    """``fn(*args)`` with LocalState's attention swapped for ``attn_fn``."""
    kernel = attention.local_attention
    attention.local_attention = attn_fn
    try:
        return fn(*args)
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
    from aero_tpu_torch.data import audio_io

    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * LR_SR)) / LR_SR
    f0 = 120.0 + 60.0 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / LR_SR
    x = sum(0.2 / k * np.sin(k * phase) for k in range(1, 8))
    audio_io.save(path, (x + 0.01 * rng.standard_normal(t.shape))[None],
                  LR_SR)
    return t.size


def device_profile(fn, what, smi):
    """Wall time, device busy time, idle share and top 15 kernels of one
    call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    # busy = the union of the device activities' intervals: kernels on
    # several streams (cuDNN's bidirectional LSTM) overlap, so their sum
    # can exceed the wall time
    busy_us, end_us = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if e.device_type == cuda):
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    kernels = [e for e in prof.key_averages() if e.device_type == cuda]
    summed_us = sum(e.self_device_time_total for e in kernels)
    idle = 1 - busy_us / 1e6 / wall
    log(f"profiled {what}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms (kernel times summed {summed_us / 1e3:.1f} "
        f"ms), idle share {idle:.3f} [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")
    return idle


def profile_forward(gen, fwd, x, smi):
    """Per-layer device time (CUDA events around modules) and the device's
    busy share of one forward (torch.profiler)."""
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
    return device_profile(lambda: fwd(x), f"forward B={BATCH}", smi)


def serving(attention, smi):
    """Phase 5 and the serving numbers; returns the forward kernel's
    launches in the batch-16 forward."""
    from aero_tpu_torch import predict
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)
    from aero_tpu_torch.train.from_jax import (
        load_reference_checkpoint, save_reference_checkpoint)

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
        out = predict.main([
            "experiment=aero_4-16_512_64", "dset=4-16",
            f"+filename={wav}", f"+output={tmp}/out",
            f"checkpoint_file={ckpt}", "precision=bfloat16", "device=cuda"])
        log(f"predict CLI (main): 35 s file, {n_in} -> {out['out_samples']} "
            f"samples, realtime factor {out['realtime_factor']:.1f}x")
        if out["out_samples"] != 4 * n_in:
            raise AssertionError("predict output is not 4x the input")

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
    profile_forward(gen, fwd, x, smi)
    return launches


def train_setup(precision, batch):
    """Config, models, TrainStep and bench.py's batch (0.1 N(0, 1) from
    default_rng(0), lr then hr) for the canonical experiment."""
    from aero_tpu_torch.train.build import build_models, segment_shapes
    from aero_tpu_torch.train.train_step import TrainStep
    from aero_tpu_torch.utils.config import load_config

    args = load_config(CONF, "main_config", [
        "experiment=aero_4-16_512_64", "dset=4-16",
        f"precision={precision}"])
    args.experiment.batch_size = batch
    models = build_models(args, "cuda", seed=0)
    lr_shape, hr_shape = segment_shapes(args.experiment)
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal(lr_shape)).astype(np.float32)
    hr = (0.1 * rng.standard_normal(hr_shape)).astype(np.float32)
    return models, TrainStep(args, models, "cuda"), lr, hr


def train_gaps(attention):
    """One step's losses and generator gradient at batch 4 with the
    kernels against the plain attention under autograd: the losses, the
    whole gradient, and each LocalState leaf alone (the attention's
    gradient reaches the network behind DConv's 1e-3 LayerScale, so the
    whole gradient would hardly see a wrong backward)."""
    from aero_tpu_torch.models.modules import LocalState

    for precision, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
        models, step, lr, hr = train_setup(precision, 4)
        gen = models["generator"]
        names = [n for n, _ in gen.named_parameters()]
        # key.bias shifts every score of a query alike: its gradient is
        # zero but for rounding, so only the whole gradient holds it
        attn_leaves = [f"{m}.{n}" for m, mod in gen.named_modules()
                       if isinstance(mod, LocalState)
                       for n, _ in mod.named_parameters()
                       if n != "key.bias"]
        g_k, _, m_k, _ = step.grads(lr, hr)
        g_p, _, m_p, _ = forward_with(
            attention, attention.reference_attention, step.grads, lr, hr)
        loss_gap = max(abs(m_k[n] - m_p[n]) / abs(m_p[n]) for n in m_p)
        flat_k = torch.cat([g.flatten().float() for g in g_k])
        flat_p = torch.cat([g.flatten().float() for g in g_p])
        grad_gap = float((flat_k - flat_p).norm() / flat_p.norm())
        leaf_gaps = {}
        for name in attn_leaves:
            i = names.index(name)
            a, e = g_k[i].float(), g_p[i].float()
            leaf_gaps[name] = float((a - e).norm() / e.norm())
        worst = max(leaf_gaps, key=leaf_gaps.get)
        log(f"train step B=4 {precision}, kernels vs plain attention: "
            f"max relative loss gap {loss_gap:.3e} (< "
            f"{TRAIN_LOSS_GAP[dtype]:g}), generator gradient relative L2 "
            f"{grad_gap:.3e} (< {TRAIN_GRAD_GAP[dtype]:g}), each of "
            f"{len(leaf_gaps)} LocalState leaves relative L2 <= "
            f"{leaf_gaps[worst]:.3e} ({worst}; < "
            f"{TRAIN_ATTN_LEAF_GAP[dtype]:g}); losses "
            + ", ".join(f"{n} {v:.5f}" for n, v in m_k.items()))
        log("  LocalState leaves: " + ", ".join(
            f"{n.replace('dconv.layers.', '')} {v:.2e}" for n, v in leaf_gaps.items()))
        if not (loss_gap < TRAIN_LOSS_GAP[dtype]
                and grad_gap < TRAIN_GRAD_GAP[dtype]
                and len(leaf_gaps) >= 4
                and leaf_gaps[worst] < TRAIN_ATTN_LEAF_GAP[dtype]):
            raise AssertionError(f"train step with kernels disagrees with "
                                 f"plain in {precision}")
        del models, step, g_k, g_p
        torch.cuda.empty_cache()


def training(attention, smi):
    """Phase 6 at batch 16 in bfloat16; returns the launch counts of one
    step."""
    models, step, lr, hr = train_setup("bfloat16", BATCH)
    n_params = {n: sum(p.numel() for p in m.parameters())
                for n, m in models.items()}
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in models.items()}
    attention.local_attention.launches = 0
    attention.local_attention.backward_launches = 0
    metrics = step(lr, hr)
    torch.cuda.synchronize()
    launches = {"forward": attention.local_attention.launches,
                "backward": attention.local_attention.backward_launches}
    # 4 attention calls forward and 4 backward, each backward 2 kernels
    log(f"train step B={BATCH} x 2 s bf16 ({n_params} params): metrics "
        + ", ".join(f"{n} {v:.5f}" for n, v in metrics.items())
        + f"; attention kernel launches {launches}")
    if launches != {"forward": 4, "backward": 8}:
        raise AssertionError(f"expected 4 forward and 8 backward attention "
                             f"kernel launches per step, got {launches}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    for name, model in models.items():
        moved = max(float((p.detach() - q).abs().max())
                    for p, q in zip(model.parameters(), before[name]))
        log(f"  {name}: largest weight change {moved:.3e}")
        if not moved > 0:
            raise AssertionError(f"{name} weights did not change")
    del before

    for _ in range(2):
        step(lr, hr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(lr, hr)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    med = statistics.median(runs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train step B={BATCH} x 2 s bf16: {med * 1e3:.1f} ms (median of "
        f"{len(runs)}: {', '.join(f'{r * 1e3:.1f}' for r in runs)}), "
        f"throughput {BATCH * 2 / med:.1f} audio-s/s, peak memory "
        f"{peak:.2f} GiB [{smi}]")
    device_profile(lambda: step(lr, hr), f"train step B={BATCH}", smi)
    return launches


def bound(shape, backward: bool, with_lse: bool):
    """(ms, 'bytes' or 'operations'): the least time of one call in bf16:
    4 * C' FLOP per (query, key) pair forward, 8 * C' backward, against
    the bf16 tensor peak; each input read and each output written once,
    against HBM bandwidth."""
    b, t, h, c = shape
    rows = b * h
    flops = (8 if backward else 4) * c * rows * t * t
    tensor, vector = rows * t * c * 2, rows * t * 4  # bf16 [r,T,C], f32 [r,T]
    if backward:  # q k v out g, w lse in; dq dk dv, dw out
        nbytes = 8 * tensor + 3 * vector
    else:         # q k v, w in; out (and lse) out
        nbytes = 4 * tensor + (2 if with_lse else 1) * vector
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sdpa_call(q, k, v, w):
    """scaled_dot_product_attention on the same inputs: [B, H, T, C'] and
    a float bias -w_s |t - s| with -inf on the diagonal (the kernel has
    -100 there) that requires grad. Returns (fn, inputs, dw of a bias
    gradient)."""
    import torch.nn.functional as F

    t = q.shape[1]
    idx = torch.arange(t, device=q.device, dtype=torch.float32)
    dist = (idx[None, :] - idx[:, None]).abs()                   # [s, t]
    bias = (-w.permute(0, 2, 1).float()[..., None] * dist).to(q.dtype)
    bias.masked_fill_(torch.eye(t, dtype=torch.bool, device=q.device),
                      float("-inf"))                              # [B,H,s,t]
    ins = [x.permute(0, 2, 1, 3).detach().requires_grad_() for x in (q, k, v)]
    ins.append(bias.requires_grad_())

    def fn(qq, kk, vv, bb):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=bb,
                                              scale=1.0)

    def dw(dbias):  # [B, H, s, t] -> [B, s, H]
        d = dbias.float().nan_to_num(0.0, 0.0, 0.0)
        return -(d * dist).sum(-1).permute(0, 2, 1)
    return fn, ins, dw


def attention_numbers(attention, smi):
    """Per call at each shape: forward and backward kernel, plain and
    library times and bounds (bf16); the library call's error against the
    plain version at the train shapes. Returns {shape name: numbers}."""
    out = {}
    for name, shape in (("train_enc2", TRAIN_ENC2), ("train_enc3", TRAIN_ENC3),
                        ("serve_enc2", ENC2), ("serve_enc3", ENC3)):
        train = name.startswith("train")
        q, k, v, w = attn_inputs(shape, torch.bfloat16, seed=200)
        b, t, h, c = shape
        fold = [attention._fold(x, b, t, h, c) for x in (q, k, v)]
        wf = attention._fold_w(w, b, t, h)
        o_f, lse = attention._kernel_fwd(*fold, wf, with_lse=True)
        g_f = torch.randn_like(o_f)
        o, g = attention._unfold(o_f, b, t, h, c), attention._unfold(
            g_f, b, t, h, c)
        fn, ins, dw_of = sdpa_call(q, k, v, w)
        y = fn(*ins)
        g_sdpa = g.permute(0, 2, 1, 3).contiguous()

        def sdpa_bwd():
            with torch.enable_grad():
                torch.autograd.grad(y, ins, g_sdpa, retain_graph=True)

        def fwd_kernel():
            attention._kernel_fwd(*fold, wf, with_lse=train)

        def bwd_kernel():
            attention._kernel_bwd(*fold, wf, o_f, lse, g_f)

        calls = {  # name: (function, arguments, repeats)
            "fwd": (fwd_kernel, (), 10),
            "fwd_plain": (attention.reference_attention, (q, k, v, w), 2),
            "fwd_lib": (fn, ins, 5),
            "bwd": (bwd_kernel, (), 10),
            "bwd_plain": (attention.reference_attention_bwd,
                          (q, k, v, w, o, g), 2),
            "bwd_lib": (sdpa_bwd, (), 5)}
        order = ["fwd_plain", "bwd_plain", "fwd", "bwd", "fwd_lib", "bwd_lib"]
        ms = {key: [] for key in calls}
        for key in order + order[::-1]:  # plain, kernel, ..., kernel, plain
            f, a, n = calls[key]
            with torch.no_grad():
                ms[key].append(time_ms(f, a, n))
        row = {key: statistics.mean(v) for key, v in ms.items()}
        row["fwd_bound"], row["fwd_bound_by"] = bound(shape, False, train)
        row["bwd_bound"], row["bwd_bound_by"] = bound(shape, True, False)
        if train:  # the library call's error against the plain version
            with torch.no_grad():
                ref = attention.reference_attention(q, k, v, w).float()
                want = attention.reference_attention_bwd(q, k, v, w, o, g)
            grads = torch.autograd.grad(y, ins, g_sdpa, retain_graph=True)
            got = [x.permute(0, 2, 1, 3) for x in grads[:3]] + [
                dw_of(grads[3])]
            row["lib_fwd_err"] = float(
                (y.detach().permute(0, 2, 1, 3).float() - ref).abs().max())
            row["lib_bwd_err"] = max(float((a.float() - e.float()).abs().max())
                                     for a, e in zip(got, want))
        del y, ins, fn
        torch.cuda.empty_cache()
        out[name] = row
        lib_err = (f"; library max abs err vs plain: fwd "
                   f"{row['lib_fwd_err']:.3e}, bwd {row['lib_bwd_err']:.3e}"
                   if train else "")
        log(f"attention {name} [B*F,T,H,C']={shape} bf16, ms per call: "
            f"forward kernel {row['fwd']:.3f}, plain {row['fwd_plain']:.3f},"
            f" library {row['fwd_lib']:.3f}, bound {row['fwd_bound']:.4f} "
            f"({row['fwd_bound_by']}); backward kernel {row['bwd']:.3f}, "
            f"plain {row['bwd_plain']:.3f}, library {row['bwd_lib']:.3f}, "
            f"bound {row['bwd_bound']:.4f} ({row['bwd_bound_by']})"
            f"{lib_err} [{smi}]")
    return out


def main():
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aero_tpu_torch.ops import _build, attention

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")
    print_ptxas(_build.build_log)

    # 3-4. kernels against plain
    fwd_err = check_kernel(attention)
    bwd_abs, bwd_rel = check_backward(attention)

    # 5. serving
    serve_launches = serving(attention, smi)

    # 6. training
    train_gaps(attention)
    train_launches = training(attention, smi)

    # 7. attention numbers
    nums = attention_numbers(attention, smi)

    def per_step(key):  # 2 calls at each train shape per step
        return 2 * (nums["train_enc2"][key] + nums["train_enc3"][key])

    def entry(name, d, src, line, launches, err, rel):
        return {
            "name": name, "route": "cuda",
            "source": f"aero_tpu_torch/csrc/{src}",
            "replaces": f"aero_tpu/ops/attention.py:{line}",
            "launches": launches, "max_abs_err": err, "max_rel_err": rel,
            "ms": per_step(d), "plain_ms": per_step(f"{d}_plain"),
            "bound_ms": per_step(f"{d}_bound"),
            "bound_by": nums["train_enc2"][f"{d}_bound_by"],
            "library_ms": per_step(f"{d}_lib"),
            "per_call": {n: {k: r[k] for k in (d, f"{d}_plain", f"{d}_lib",
                                               f"{d}_bound")}
                         for n, r in nums.items()}}

    kernels = [
        entry("local_attention_fwd", "fwd", "local_attention.cu", 298,
              train_launches["forward"], fwd_err, None),
        entry("local_attention_bwd", "bwd", "local_attention_bwd.cu", 422,
              train_launches["backward"], bwd_abs, bwd_rel)]
    kernels[0]["launches_serving_forward"] = serve_launches
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
