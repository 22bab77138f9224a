#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one GPU and
check them.

Run from the repository root, on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (so the exit code is not 0) and
prints its time:

1. the card: its name and power limit from nvidia-smi; no CUDA -> fail;
2. build the CUDA kernels from aero_tpu_torch/csrc with nvcc (sm_90a, one
   nvcc per source, all at once) and print each kernel instance's
   registers and spills, and the instances that spill; a tensor-core
   backward instance at head width 12 or 24 that spills fails;
3. the LocalState attention forward kernels against their plain PyTorch
   version at head widths 12 and 24, T = 500 .. 6891, at width 48 at T =
   500, 2501 and 4097, at every width of KERNEL_WIDTHS at T = 777 in
   bfloat16, and at the serving and train shapes (phase 12's included);
   float32 (TF32 off, the SIMT kernel) to atol 1e-3, bfloat16 (the
   tensor-core kernel, which each bfloat16 call must take) to 3e-2. With
   a band W (16, 128, and at widths 12 and 24 W >= T - 1, which must
   equal the exact kernel bit for bit) against
   ``banded_reference_attention`` at T = 500 .. 4097 and at the serving
   shapes;
4. the backward kernels through ``torch.autograd.grad`` of
   ``local_attention`` against ``reference_attention_bwd`` (dq, dk, dv, dw
   within tol * max|want|: 1e-4 in float32 on the SIMT kernels, 2e-2 in
   bfloat16 on the tensor-core kernels, which each call must take) and
   the forward's log-sum-exp against ``logsumexp`` of the plain scores,
   at T = 501 .. 4097 (width 48: 501 and 2501) and at the train shapes,
   exact and with bands 16 and 128; a second call on the same inputs must
   give bit-identical gradients;
5. the LSTM recurrence kernels (float32 SIMT, bfloat16 tensor cores)
   against ``reference_lstm_recurrence`` at the serving shapes (N 3328 /
   H 48, N 1664 / H 96, T 200), at H 8, 72 and 128 and at ragged N (1000,
   1001), and the fused FTB tail kernel against its plain version
   at the four encoder shapes (B 16, T 2501) and at a ragged T and C',
   both in float32 (SIMT) and bfloat16 (tensor cores), and in bfloat16 at
   channel strides of 12 and 10 bytes mod 16 and with x and y at odd
   phases (tolerances LSTM_ATOL and FTB_TOL);
6. serving: the canonical aero_4-16_512_64 generator from the seeded init
   in bfloat16, saved as a reference .th and loaded back as the CLI loads
   it: one forward at batch 16 x 10 s that must launch the forward kernel 4
   times, all on the tensor cores, the kernel-vs-plain gap of the whole
   forward on one chunk in
   float32 and bfloat16, and the predict CLI on a 35 s file. Then the same
   generators with the opt-in switches (AERO_LSTM_KERNEL=1,
   AERO_FTB_KERNEL=1, AERO_ATTN_BAND=128): one forward that must launch the
   LSTM kernel 8 times, the banded attention 4 times and the FTB kernel 4
   times, all on the tensor cores, and the whole-forward gap against
   the three plain versions, and the opt-in forward's distance from the
   default one (printed);
7. training: the canonical generator and MelGAN discriminator from the
   seeded init. At batch 4, one step's losses, generator gradient and each
   LocalState gradient leaf with the kernels against the same step with
   the plain attention under autograd, in float32 and bfloat16 (in
   float32 both runs on the same side of each of the STFT loss's
   magnitude floors, ``pinned_floors``). Then
   bfloat16 at batch 16 x 2 s with bench.py's batch: 4 forward kernel
   launches and 4 backward calls of 2 kernels each per step, all on the
   tensor cores,
   finite metrics, both networks' weights changed, the median step time
   of 5 after 2 warm-ups, throughput, peak memory, and a profiled step's
   top kernels and idle share;
8. numbers: per attention call at the train and serving shapes (the
   width-48 decoder's of phase 12 (a) and (b) included), the
   forward and backward kernels' times against their plain versions, the
   library call (scaled_dot_product_attention with a float bias) and the
   bound; per call at the opt-in serving path's shapes, the banded
   forward, the LSTM recurrence and the FTB tail against their plain
   versions, their library yardsticks (SDPA with a banded bias; one
   bidirectional cuDNN ``nn.LSTM`` layer, which includes the input
   projection, beside the port's projection matmul plus recurrence; none
   computes the FTB tail; the FTB kernel also alone, without the
   wrapper's transpose of h and packing of the weights) and bounds. A
   bound is the largest of the bytes at the HBM rate, the operations at
   the bf16 tensor peak and the exponentials at the special-function
   units' rate (16 per SM and clock at the max SM clock); the LSTM's
   carries a note of its 200 dependent steps, the backward's one of its
   two exponentials per pair;
9. the Solver: ``main`` of ``python -m aero_tpu_torch.train``,
   ``aero_tpu_torch.test`` and ``aero_tpu_torch.predict`` in this process
   on 40 dummy files of 2.5 s: train 2 epochs (bfloat16, batch 16 x 2 s,
   cross-validation on the test files every epoch, LSD at the end,
   ``profile=true``), resume for a third, score the test set and predict a
   12.3 s file from checkpoint.atpu. It raises unless profile/ holds one
   trace, of step 1 of epoch 0, naming the three attention kernels, every
   train step launched 4 forward
   and 8 backward attention kernels and every valid or eval forward 4, all
   on the tensor cores, the history and LSD are finite, the resume ran
   epoch 3 alone, the samples are written and the prediction is 4x its
   input; it prints the epoch and median step times, the valid, loss and
   eval times a file, checkpoint save and load times and peak memory;
10. HiFi and Seanet: the HiFi losses (the train step's LossComputer with
   its storing discriminator pass), the discriminators' gradient and the
   stored u of the canonical MPD and MSD at B = 2 x 0.5 s in float32 with
   TF32 off, the card against the CPU, within 1e-4 relative; the canonical
   generator trained against ``discriminator_models=[hifi]`` and
   seanet_4-16 against its MelGAN, each at B = 16 x 2 s in bfloat16 (one
   checked step, then 2 warm-ups, the median of 5 and a profiled step:
   step time, throughput, peak memory, idle share, top kernels), raising
   unless every HiFi step launched 4 forward and 8 backward attention
   kernels on the tensor cores (Seanet's none), every loss is finite,
   every network changed and each stored u is finite and moved; the
   Seanet forward in float32 on the card against the CPU (1e-4 relative
   L2), its serving forward at B = 16 x 10 s (realtime factor, profile)
   and the predict CLI on a 35 s file from a port-written ``.atpu``,
   whose output must be 4x its input;
11. data parallel (``aero_tpu_torch.parallel.mesh``): (a) two ranks
   spawned on the one card over gloo (NCCL refuses two ranks on one GPU),
   the canonical generator and MelGAN in float32 without TF32, bench.py's
   batch of 4 x 2 s (2 rows a rank), accum_steps 1 and 2, against one
   process on the 4 rows, the ranks and the witness below on the sides
   of the STFT loss's magnitude floors that one process took
   (``pinned_floors``): losses
   within 1e-5 relative, each network's gradient within 1e-4 relative L2
   or, where one process's own gradient moves more than that when it
   takes each microbatch's rows in another order (the rounding witness),
   within 4x that move; the weights equal bit for bit across ranks, 4 + 8
   attention launches a step (x accum) on each rank; printed beside the
   control (one process on rank 0's 2 rows alone, which must miss by over
   10x the bounds) and the witness; (b) the
   bfloat16 step at batch 16 x 2 s in a one-rank NCCL group, so that every
   collective of the path runs: 4 + 8 launches on the tensor cores each
   step, the median of 5 beside phase 7's and a profiled step with the
   NCCL kernels' device time; (c) the 35 s predict file split over
   [cuda:0, cuda:0], one replica each, against one device (float32 within
   1e-5 relative L2, bfloat16 printed), and the predict CLI with
   ``+devices=[cuda:0,cuda:0]``;
12. generator options at the canonical width, seed-0 init (``generator_
   options``): (a) serving with ``dconv_mode=3`` at batch 16 x 10 s in
   bf16: 8 forward launches on the tensor cores, 2 each at enc2 (C' 12),
   enc3 (24) and the decoders of plan index 2 (24) and 3 (48), the
   whole-forward gap to plain (bf16 2e-2, f32 1e-3), the realtime factor
   and the device ms of the program's spans, and with the opt-in switches
   12 LSTM launches (4 in the decoder at H 96; H 192 takes cuDNN), 8
   banded and 4 FTB; (b) its
   train step: phase 7's B = 4 gaps, and at B = 16 x 2 s 8 + 16 launches a
   step, the median of 5, peak memory and a profiled step; (c) serving
   with ``freq_ends=2, act_func=gelu``: enc3 on the time axis, its 2
   launches at T 1251, the gap to plain and the realtime factor; (d) a
   LocalState with nfreqs 2 in f32 on the card against the CPU (1e-4
   relative L2, no kernel launched) and one with ndecay 0 against its
   plain version; (e) the predict CLI with ``experiment.upsample=true`` and
   ``experiment.aero.spec_upsample=false`` on the 35 s file, whose output
   has the 16 kHz resampled input's length;
13. none: the other phases keep the numbers that logs and notes cite;
14. the port's tools (``repro_and_tools``, in ``build/phase14``, removed
   after): (a) ``bash aero_tpu_torch/tools/repro_vctk.sh --dry-run`` as a
   subprocess (108 synthesized speakers, resampling and egs jsons for real,
   the 100/8 split), then the train and test commands it printed, run in
   this process through ``main`` of the CLIs with two overrides appended:
   ``epochs=1`` (for 125) and ``visqol=false`` (the utterances last 0.25 s,
   under ViSQOL's patch, so the scorer fails on each by design): 4 forward
   and 8 backward attention launches a step on the tensor cores, a finite
   history and test LSD, a checkpoint.atpu; (b) the band probe
   (``aero_tpu_torch.tools.attn_band_probe``) at its defaults on (a)'s
   checkpoint: the float32 forward on the card (4 launches on the SIMT
   kernel, at enc2's [8, 2501, 4, 12] twice and enc3's [4, 2501, 4, 24]
   twice) and its table, then at each site and W in 32 .. 512 the float32
   kernels, exact and banded, on the captured inputs, each against its
   plain version (atol 1e-3) and their row-wise relative difference against
   the probe's dense out_rel_max within 1e-4 absolute; the same in
   bfloat16 on the tensor cores, printed; (c) ``main`` of
   ``aero_tpu_torch.tools.train_variants which=8-24,11-44 epochs=1`` and
   of ``aero_tpu_torch.tools.ab_precision epochs=1 n_files=16``, each train
   CLI subprocess they start run as ``main`` of the train CLI in its run
   directory instead (in this process, so that the launches are counted):
   aero_8-24_512_64 and aero_11-44_512_64 with MPD + MSD and accum_steps 4
   (bf16, B 16, 48 files of 3 s), the canonical config in float32 and
   bfloat16 (B 8, 16 files): each run one finite epoch with 4 forward and 8
   backward attention launches per microbatch (on the tensor cores in
   bfloat16, on the SIMT kernels in float32); each run's step times, peak
   memory, ViSQOL average and the files the scorer failed on, printed;
15. ``EvalForward``'s CUDA graphs (``cuda_graphs``), the canonical bf16
   generator at the speech files cell's 12 forwards (1 x 4000 .. 1 x 40000,
   2 and 3 x 40000) and at 4, 6, 8, 12 and 16 x 40000, under cuDNN's
   deterministic algorithms: the first call eager, the second a capture
   (the first capture after the pool's floor), the third a replay up to
   ``GRAPH_MAX_SAMPLES`` (three eager calls above it, and music's
   16 x 110250 eager by the rule); every output within GRAPH_GAP relative
   L2 of an eager forward's; 10 replays move no kernel wrapper's counter;
   a profiled replay runs the eager forward's 4 attention kernels on the
   device; the graphs' pool within POOL_GROWTH of its first capture's.
   Then per shape, in the default algorithms: host ms of the eager
   launches and of the eager forward, the graph's device ms, the replayed
   forward's host ms and the pool one graph alone holds;
16. the GroupNorm kernel pair (``group_norm_kernels``): every GroupNorm
   site of the canonical generator at speech (T 2501) and music (T 6892),
   batch 1 and 16, in bfloat16 (speech batch 1 in float32 too), against
   the plain version (GN_TOL), eagerly and as two replays of a CUDA graph
   that must give the eager bits and move no counter; ragged T, a GLU
   half-plane no vector width divides and misaligned x; a served forward
   launches the pair at every site and takes no autograd path, a forward
   under autograd the reverse; per site at speech batch 1 and 16 the
   pair's ms beside its bound, the plain version, the library call and the
   chain the port ran before.

The last lines are the kernels' JSON, the card's name and power limit,
and the result JSON.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
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
# with dconv_mode 3 the decoders run DConv on 2 * chout channels too: the
# decoder of plan index 2 (384 channels, hidden 96) and of index 3 (768,
# hidden 192, the head width 48)
DEC2 = (BATCH * 8, 2501, 4, 24)
DEC3 = (BATCH * 4, 2501, 4, 48)
TRAIN_DEC3 = (BATCH * 4, 501, 4, 48)
# with freq_ends 2 enc3 strides the time axis: F stays 8, T 2501 -> 1251
TIME_ENC3 = (BATCH * 8, 1251, 4, 24)
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
# special-function unit: 16 exponentials (ex2) a clock per SM
SFU_PER_SM_CLOCK = 16
# The opt-in serving path: the JAX package's three switches
BAND = 128
OPT_IN = {"AERO_LSTM_KERNEL": "1", "AERO_FTB_KERNEL": "1",
          "AERO_ATTN_BAND": str(BAND)}
# LSTM recurrence at the serving shapes, (N, H) with T = 200: B*F*26 chunks
LSTM_STEPS = 200
LSTM_ENC2, LSTM_ENC3 = (BATCH * 8 * 26, 48), (BATCH * 4 * 26, 96)
# max|kernel - plain| of h in [-1, 1]: float32 sums in another order over
# 200 dependent steps; in bfloat16 h is rounded every step, so one rounding
# that falls the other way (2^-8 near 1) travels on through the recurrence
LSTM_ATOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# FTB tail at the serving shapes, [B, C, F, T] from enc0 to enc3
FTB_SHAPES = ((BATCH, 48, 256, 2501), (BATCH, 48, 64, 2501),
              (BATCH, 96, 16, 2501), (BATCH, 192, 8, 2501))
# max|kernel - plain| <= tol * max|plain|: float32 2C-term sums in another
# order; bfloat16 rounds the output once, so up to 2 ulps (2^-6 relative)
FTB_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# GroupNorm with its activation (phase 16), max|kernel - plain| <= tol *
# max|plain|: float32 statistics in another order (Welford slices against
# aten's rows), erf and sin within ulps; bfloat16 rounds once, so a float32
# gap across a rounding boundary moves an output one ulp (2^-8 of it)
GN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# speech and music 10 s chunks: T 2501 and 6892 analysis frames
GN_CHUNKS = {"speech": 4000 * SECONDS, "music": 11025 * SECONDS}
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


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def switches(env):
    """The process environment with ``env`` set, restored afterwards (the
    port reads its switches at call time)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def print_ptxas(build_log: str):
    """One line per kernel instance (name<dtype, template width: the head
    width C', H/8 or the output-channel tile; the tensor-core kernels,
    bfloat16 only, C' or H): registers, shared memory and spills, from
    nvcc -Xptxas=-v. Returns the names of the instances that spill."""
    name, spill, spilling = "?", "", []
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"((?:local_attention|lstm_recurrence|ftb_tail)"
                          r"[a-z_]*_kernel)"
                          r"I(?:(f|13__nv_bfloat16)Li|Li)(\d+)E", line)
            name = (f"{m[1]}<{'f32' if m[2] == 'f' else 'bf16'}, {m[3]}>"
                    if m else line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; {spill}")
            if not spill.startswith("0 bytes stack frame, 0 bytes spill"):
                spilling.append(name)
    return spilling


def attn_inputs(shape, dtype, seed):
    b, t, h, c = shape
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, t, h, c, generator=g) / c ** 0.5
    k = torch.randn(b, t, h, c, generator=g)
    v = torch.randn(b, t, h, c, generator=g)
    # decay slopes from 1e-4 (near-global attention) to 0.1 (local)
    w = 10.0 ** (-4.0 + 3.0 * torch.rand(b, t, h, generator=g))
    return [x.to(dtype).cuda() for x in (q, k, v, w)]


def plain_attention(attention):
    """The plain version of ``local_attention``, band included."""
    def fn(q, k, v, w, band=0):
        if band > 0:
            return attention.banded_reference_attention(q, k, v, w, band)
        return attention.reference_attention(q, k, v, w)
    return fn


def check_kernel(attention, cases, path_shapes) -> float:
    """Each case (shape, dtype, band; band 0 is exact) within its
    tolerance, on the route its dtype names (bfloat16: the tensor-core
    kernel), a band W >= T - 1 bit for bit the exact kernel; returns the
    max error at ``path_shapes`` (bfloat16)."""
    path_err = 0.0
    plain = plain_attention(attention)
    fn = attention.local_attention
    for i, (shape, dtype, band) in enumerate(cases):
        xs = attn_inputs(shape, dtype, seed=i + 100 * band)
        mma = fn.mma_launches
        got = fn(*xs, band=band)
        torch.cuda.synchronize()
        if fn.mma_launches - mma != int(dtype == torch.bfloat16):
            raise AssertionError(f"{dtype} at {shape} took the wrong route")
        want = plain(*xs, band=band)
        err = (got.float() - want.float()).abs().max().item()
        tol = F32_ATOL if dtype == torch.float32 else BF16_ATOL
        exact = ""
        if band >= shape[1] - 1:
            same = torch.equal(got, attention.local_attention(*xs))
            exact = f"; equals the exact kernel: {same}"
            if not same:
                raise AssertionError(f"band {band} >= T - 1 differs from the "
                                     f"exact kernel at {shape} {dtype}")
        log(f"  kernel vs plain {str(dtype)[6:]:8s} [B,T,H,C']={shape} "
            f"band {band}: max abs err {err:.3e} (atol {tol:g}){exact}")
        if not err <= tol:
            raise AssertionError(f"kernel disagrees with plain at {shape} "
                                 f"{dtype} band {band}: {err} > {tol}")
        if shape in path_shapes:
            path_err = max(path_err, err)
    return path_err


def check_backward(attention, cases):
    """The backward through autograd against ``reference_attention_bwd``
    and the forward's log-sum-exp against ``logsumexp`` of the plain
    scores, at every case (shape, dtype, band): ``torch.autograd.grad`` of
    ``local_attention`` must launch the forward kernel once and both
    backward kernels, and hold dq, dk, dv and dw. Returns (max abs error,
    max error / max|want|) over the train shapes' gradients (bfloat16)."""
    train_abs = train_rel = 0.0
    fn = attention.local_attention
    for i, (shape, dtype, band) in enumerate(cases):
        xs = [x.requires_grad_() for x in
              attn_inputs(shape, dtype, seed=1000 + i + 100 * band)]
        b, t, h, c = shape
        g = torch.randn(b, t, h, c, device="cuda").to(dtype)
        before = (fn.launches, fn.backward_launches, fn.banded_launches,
                  fn.backward_mma_launches)
        out = fn(*xs, band=band)
        got = torch.autograd.grad(out, xs, g)
        torch.cuda.synchronize()
        launched = (fn.launches - before[0], fn.backward_launches - before[1],
                    fn.banded_launches - before[2],
                    fn.backward_mma_launches - before[3])
        if launched != (1, 2, int(band > 0), 2 * (dtype == torch.bfloat16)):
            raise AssertionError(f"autograd at {shape} {dtype} band {band} "
                                 f"launched {launched} forward, backward, "
                                 "banded and tensor-core backward kernels")
        again = torch.autograd.grad(fn(*xs, band=band), xs, g)
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            raise AssertionError(f"backward at {shape} {dtype} band {band} "
                                 "differs between two calls")
        q, k, v, w = (x.detach() for x in xs)
        want = attention.reference_attention_bwd(q, k, v, w, out.detach(), g,
                                                 band=band)
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
                                       with_lse=True, band=band)
        with torch.no_grad():
            t_idx = torch.arange(t, device="cuda", dtype=torch.float32)
            scores = [attention._scores(
                q.float(), k.float(), w.float().permute(0, 2, 1), t_idx,
                s0, min(s0 + 256, t), band)[0] for s0 in range(0, t, 256)]
            want_lse = torch.cat([sc.logsumexp(2) for sc in scores], dim=2)
        lse_err = (lse.view(b, h, t) - want_lse).abs().max().item()
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"lse at {shape} {dtype} band {band}: "
                                 f"{lse_err}")
        log(f"  backward vs plain {str(dtype)[6:]:8s} [B,T,H,C']={shape} "
            f"band {band}: "
            + " ".join(f"{n} {e:.2e} ({r:.1e} of max)" for n, (e, r) in
                       zip(("dq", "dk", "dv", "dw"), errs))
            + f"; tol {tol:g} of max; lse {lse_err:.2e}; bit-identical "
            "across two calls")
        if shape in (TRAIN_ENC2, TRAIN_ENC3, TRAIN_DEC3):
            train_abs = max([train_abs] + [e for e, _ in errs])
            train_rel = max([train_rel] + [r for _, r in errs])
    return train_abs, train_rel


def lstm_inputs(n, hd, dtype, seed):
    """xp [200, 8H, N] ~ 0.5 N(0, 1) in ``dtype``; W_hh [2, 4H, H] and the
    bias [8H] uniform in +-1/sqrt(H) (nn.LSTM's init), float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xp = 0.5 * torch.randn(LSTM_STEPS, 8 * hd, n, device="cuda", generator=g)
    w = (2 * torch.rand(2, 4 * hd, hd, device="cuda", generator=g) - 1)
    b = (2 * torch.rand(8 * hd, device="cuda", generator=g) - 1)
    return xp.to(dtype), w / hd ** 0.5, b / hd ** 0.5


def check_lstm(lstm) -> float:
    """The recurrence kernels against the plain version at the serving
    shapes, at H 8, 72 and 128 (in float32 W_hh too large for shared
    memory; in bfloat16 K padded from 8 and 72 to 16 and 80, and 16
    sequences a block at 128) and at ragged N (not a multiple of the
    sequence tile; N 1001, not a multiple of 8, copies xp without
    cp.async), float32 on the SIMT kernel and bfloat16 on the tensor-core
    kernel; returns the max error at the serving shapes (bfloat16)."""
    path = (LSTM_ENC2, LSTM_ENC3)
    cases = [(s, dt) for dt in (torch.float32, torch.bfloat16)
             for s in path + ((512, 8), (320, 72), (256, 128), (1000, 48),
                              (1001, 96))]
    path_err = 0.0
    for i, ((n, hd), dtype) in enumerate(cases):
        xp, w, b = lstm_inputs(n, hd, dtype, seed=300 + i)
        mma = lstm.lstm_recurrence.mma_launches
        got = lstm.lstm_recurrence(xp, w, b)
        torch.cuda.synchronize()
        if (lstm.lstm_recurrence.mma_launches - mma
                != int(dtype == torch.bfloat16)):
            raise AssertionError(f"lstm {dtype} H={hd} took the wrong route")
        want = lstm.reference_lstm_recurrence(xp, w, b)
        err = (got.float() - want.float()).abs().max().item()
        tol = LSTM_ATOL[dtype]
        log(f"  lstm kernel vs plain {str(dtype)[6:]:8s} N={n} H={hd} "
            f"T={LSTM_STEPS}: max abs err {err:.3e} (atol {tol:g}), mean "
            f"{(got.float() - want.float()).abs().mean().item():.2e}")
        if got.shape != want.shape or not err <= tol:
            raise AssertionError(f"lstm kernel disagrees with plain at N={n} "
                                 f"H={hd} {dtype}: {err} > {tol}")
        if (n, hd) in path and dtype == torch.bfloat16:
            path_err = max(path_err, err)
    return path_err


def at_offset(x, elements):
    """A contiguous copy of ``x`` that starts ``elements`` past an
    allocation's start (so its rows take another phase)."""
    flat = torch.empty(x.numel() + elements, dtype=x.dtype, device=x.device)
    out = flat[elements:].view(x.shape)
    out.copy_(x)
    return out


def ftb_inputs(shape, dtype, seed):
    """x [B, C, F, T] ~ 0.3 N(0, 1) and h [B, C, T] = relu(N(0, 1)) in
    ``dtype``; Ka, Kb [C, C] ~ N(0, 1/C), W_freq [F, F] ~ N(0, 1/F) and
    b2 [C] ~ 0.1 N(0, 1), float32."""
    b, c, f, t = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, device="cuda", generator=g)
    x = (0.3 * randn(b, c, f, t)).to(dtype)
    h = torch.relu(randn(b, c, t)).to(dtype)
    return (x, h, randn(c, c) / c ** 0.5, randn(c, c) / c ** 0.5,
            randn(f, f) / f ** 0.5, 0.1 * randn(c))


def check_ftb(ftb) -> float:
    """The fused tail kernel against the plain version at the encoder
    shapes, at a ragged T with 24 channels (SIMT: one output tile of 32,
    8 of them masked; tensor cores: C and C' padded to 32) and at 100
    channels (SIMT: two tiles of 64; tensor cores: padded to 112, and a
    channel stride F T 2 = 8 mod 16, so 8-byte pieces), float32 on the
    SIMT kernel and bfloat16 on the tensor-core kernel; in bfloat16 also
    at channel strides of 12 and 10 bytes mod 16 (4- and 2-byte pieces),
    with x and y both 3 elements past their allocations (16-byte pieces,
    tiles that start before t = 0 at every f) and with x alone 1 element
    past (x and y at different phases: 2-byte pieces). Returns the max
    error at the encoder shapes (bfloat16)."""
    bf16 = torch.bfloat16
    cases = [(s, dt, 0, 0) for dt in (torch.float32, bf16)
             for s in FTB_SHAPES + ((3, 24, 40, 777), (2, 100, 12, 333))] + [
        ((2, 48, 6, 301), bf16, 0, 0), ((2, 32, 5, 257), bf16, 0, 0),
        ((2, 48, 64, 501), bf16, 3, 3), ((2, 48, 64, 501), bf16, 1, 0)]
    path_err = 0.0
    for i, (shape, dtype, x_off, y_off) in enumerate(cases):
        args = ftb_inputs(shape, dtype, seed=500 + i)
        mma = ftb.ftb_tail.mma_launches
        if x_off or y_off:  # the kernel on x and y at these phases
            x, h, ka, kb, w_freq, b2 = args
            y = ftb.freq_mix(x, w_freq)
            got = ftb._launch(at_offset(x, x_off), at_offset(y, y_off), h,
                              ka, kb, b2)
        else:
            got = ftb.ftb_tail(*args)
        torch.cuda.synchronize()
        if ftb.ftb_tail.mma_launches - mma != int(dtype == bf16):
            raise AssertionError(f"ftb {dtype} at {shape} took the wrong "
                                 "route")
        want = ftb.reference_ftb_tail(*args)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = FTB_TOL[dtype]
        log(f"  ftb kernel vs plain {str(dtype)[6:]:8s} [B,C,F,T]={shape}"
            f"{f' x, y at +{x_off}, +{y_off}' if x_off or y_off else ''}: "
            f"max abs err {err:.3e} ({err / scale:.1e} of max; tol {tol:g})")
        if got.shape != want.shape or not err <= tol * scale:
            raise AssertionError(f"ftb kernel disagrees with plain at {shape} "
                                 f"{dtype}: {err} > {tol} * {scale}")
        if shape in FTB_SHAPES and dtype == torch.bfloat16:
            path_err = max(path_err, err)
        del args, got, want
        torch.cuda.empty_cache()
    return path_err


def plain_swaps(attention, lstm, ftb):
    """Each kernel wrapper of the serving path -> its plain version."""
    return {(attention, "local_attention"): plain_attention(attention),
            (lstm, "lstm_recurrence"): lstm.reference_lstm_recurrence,
            (ftb, "ftb_tail"): ftb.reference_ftb_tail}


def forward_with(swaps, fn, *args):
    """``fn(*args)`` with each (module, name) of ``swaps`` set to its
    value: the wrappers' plain versions. ``fn`` must run its forward
    eagerly: a CUDA graph replays what it captured, whatever the names
    hold now (``eager``)."""
    kept = {key: getattr(*key) for key in swaps}
    for (module, name), value in swaps.items():
        setattr(module, name, value)
    try:
        return fn(*args)
    finally:
        for (module, name), value in kept.items():
            setattr(module, name, value)


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
    call of ``fn`` (torch.profiler), logged; returns the idle share and the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA

    def device_work(e):
        # the profiler draws each record_function range that launched device
        # work (torch's Optimizer.step) on the device's timeline as a user
        # annotation, from its first launch to its last: no work of the
        # device
        return (e.device_type == cuda
                and not getattr(e, "is_user_annotation", False))

    # busy = the union of the device activities' intervals: kernels on
    # several streams (cuDNN's bidirectional LSTM) overlap, so their sum
    # can exceed the wall time
    busy_us, end_us = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events() if device_work(e)):
        busy_us += max(0.0, end - max(start, end_us))
        end_us = max(end_us, end)
    kernels = [e for e in prof.key_averages() if device_work(e)]
    summed_us = sum(e.self_device_time_total for e in kernels)
    idle = 1 - busy_us / 1e6 / wall
    log(f"profiled {what}: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms (kernel times summed {summed_us / 1e3:.1f} "
        f"ms), idle share {idle:.3f} [{smi}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  "
            f"{e.key[:90]}")
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    if nccl:
        log(f"  NCCL collectives: "
            f"{sum(e.self_device_time_total for e in nccl) / 1e3:.3f} ms in "
            f"{sum(e.count for e in nccl)} launches")
    return idle, prof


def profile_forward(fwd, x, smi, what):
    """The device ms of one forward in the program's spans
    (``utils.profiling.attribute``) and the device's idle share
    (``device_profile``)."""
    from aero_tpu_torch.utils import profiling

    _, prof = device_profile(lambda: fwd(x), f"{what} forward B={BATCH}",
                             smi)
    spans = profiling.table(profiling.attribute(profiling.events(
        prof.profiler.kineto_results.events())))
    log(f"device ms by span, the {what} forward B={BATCH} bf16 [{smi}]:")
    for name in ("aero.encoder", "aero.decoder", "aero.blstm"):
        count, _, ms, launches = spans.get(name, [0, 0.0, 0.0, 0])
        log(f"  {name:14s} {ms:9.3f} ms  ({count} calls, {launches} "
            "launches)")


def realtime_factor(fwd, x, smi, what):
    """Logs the median wall time of 5 forwards after a warm-up, host to
    host."""
    fwd(x)
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fwd(x)
        runs.append(time.perf_counter() - t0)
    med = statistics.median(runs)
    log(f"realtime factor, {what} path, B={BATCH} bf16 {SECONDS} s chunks: "
        f"{BATCH * SECONDS / med:.1f}x (median of {len(runs)}: "
        f"{med * 1e3:.1f} ms per batch, host to host; "
        f"{', '.join(f'{r * 1e3:.1f}' for r in runs)}) [{smi}]")


def launch_counts(attention, lstm, ftb):
    return {"attention": attention.local_attention.launches,
            "attention_mma": attention.local_attention.mma_launches,
            "banded": attention.local_attention.banded_launches,
            "lstm": lstm.lstm_recurrence.launches,
            "lstm_mma": lstm.lstm_recurrence.mma_launches,
            "ftb": ftb.ftb_tail.launches,
            "ftb_mma": ftb.ftb_tail.mma_launches}


def zero_counts(attention, lstm, ftb):
    attention.local_attention.launches = 0
    attention.local_attention.mma_launches = 0
    attention.local_attention.banded_launches = 0
    lstm.lstm_recurrence.launches = 0
    lstm.lstm_recurrence.mma_launches = 0
    ftb.ftb_tail.launches = 0
    ftb.ftb_tail.mma_launches = 0


def checked_forward(fwd, x, counted, want):
    """One forward at batch 16 with the kernel counts set to 0 just before
    and read just after; the output must be finite [16, 1, 160000] and
    the counts ``want``."""
    zero_counts(*counted)
    y = fwd(x)
    launches = launch_counts(*counted)
    log(f"forward B={BATCH} x {SECONDS} s: out {y.shape}, kernel launches "
        f"{launches}")
    if y.shape != (BATCH, 1, SECONDS * HR_SR) or not np.isfinite(y).all():
        raise AssertionError(f"bad output: {y.shape}, finite "
                             f"{np.isfinite(y).all()}")
    if launches != want:
        raise AssertionError(f"expected kernel launches {want}, {launches}")
    return y, launches


def eager(fwd, lr):
    """What ``fwd(lr)`` gives, through its generator's eager forward: the
    same bucket pad and trim, never a CUDA graph."""
    with torch.inference_mode():
        y = fwd.gen(fwd._input(lr)).float()
        return y[..., :int(lr.shape[-1] * fwd.scale)].cpu().numpy()


def forward_gaps(fwd, fwd32, chunk, plain, what):
    """Whole forward of one chunk, kernels against their plain versions
    (``plain``, as ``forward_with`` takes them, run by ``eager``), in
    relative L2, bf16 and f32; raises beyond GAP_BF16 or GAP_F32."""
    gap_bf16 = rel_l2(fwd(chunk), forward_with(plain, eager, fwd, chunk))
    y32 = fwd32(chunk)
    gap_f32 = rel_l2(y32, forward_with(plain, eager, fwd32, chunk))
    gap_dtype = rel_l2(fwd(chunk), y32)
    log(f"one chunk, {what} path, kernels vs plain versions, relative L2: "
        f"bf16 {gap_bf16:.3e} (< {GAP_BF16:g}), f32 {gap_f32:.3e} (< "
        f"{GAP_F32:g}); bf16 vs f32 forward {gap_dtype:.3e}")
    if not (gap_bf16 < GAP_BF16 and gap_f32 < GAP_F32):
        raise AssertionError(f"{what} forward with kernels disagrees with "
                             "plain")


def serving(attention, lstm, ftb):
    """Phase 6; returns the kernel launches of the default and of the
    opt-in batch-16 forward."""
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
        counted = (attention, lstm, ftb)
        plain = plain_swaps(*counted)
        gen32 = build_generator(kwargs, "float32", "cuda")
        gen32.load_state_dict(state, strict=True)
        fwd32 = EvalForward(gen32, scale=HR_SR / LR_SR, lr_sr=LR_SR,
                            device="cuda")
        chunk = x[:1]

        y, launches = checked_forward(fwd, x, counted, {
            "attention": 4, "attention_mma": 4, "banded": 0, "lstm": 0,
            "lstm_mma": 0, "ftb": 0, "ftb_mma": 0})
        forward_gaps(fwd, fwd32, chunk, plain, "default")
        with switches(OPT_IN):
            y_opt, opt_launches = checked_forward(fwd, x, counted, {
                "attention": 4, "attention_mma": 4, "banded": 4, "lstm": 8,
                "lstm_mma": 8, "ftb": 4, "ftb_mma": 4})
            forward_gaps(fwd, fwd32, chunk, plain, "opt-in (" + ", ".join(
                f"{k}={v}" for k, v in OPT_IN.items()) + ")")
        log(f"opt-in vs default forward B={BATCH}, relative L2: "
            f"{rel_l2(y_opt, y):.3e} (the band and the bf16 recurrence "
            "change the function)")
        del gen32, fwd32

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
    return launches, opt_launches


STFT_FLOOR = 1e-7  # the STFT loss's floor on a bin's power |z|^2


class pinned_floors(contextlib.ContextDecorator):
    """The STFT loss with each bin of the prediction held to a recorded
    side of the magnitude floor. The loss's gradient jumps where a bin's
    power crosses the floor (below it the bin has none; just above it,
    log|z| has slope 1/|z| ~ 3.2e3), and at the seeded init the canonical
    generator's output has one bin of the 1024-point resolution within
    float32 rounding of it: two runs that differ in rounding alone (the
    kernels or the plain attention, ranks or one process, even one run and
    the next, whose convolutions the card may round differently) can take
    either side, and the generator gradient then moves 2.4e-4 relative L2.
    So the runs that a check compares share the sides: ``masks`` maps
    (resolution, the target row's digest) to that row's mask (power below
    the floor); a row not in it is recorded from this run, a row in it is
    replayed. Where the replayed side is the run's own, the loss and its
    gradient are the loss's own; ``flips`` counts the bins where it was
    not."""

    def __init__(self, masks: dict):
        self.masks, self.flips = masks, 0

    def __enter__(self):
        from aero_tpu_torch.losses import stft_loss as sl

        self.kept = loss, magnitude = sl.stft_loss, sl.stft_magnitude

        def pinned(x, y, fft_size, hop_size, win_length, all_sum=None):
            keys = [(fft_size, hashlib.sha256(
                row.detach().float().cpu().numpy().tobytes()).hexdigest())
                for row in y]

            def held(v, *shape):
                if v is not x:
                    return magnitude(v, *shape)
                z = sl.stft(v, *shape)
                power = z.real ** 2 + z.imag ** 2
                below = power < STFT_FLOOR
                for key, row in zip(keys, below):
                    self.masks.setdefault(key, row.cpu().numpy())
                mask = torch.from_numpy(np.stack(
                    [self.masks[k] for k in keys])).to(power.device)
                self.flips += int((mask != below).sum())
                return torch.sqrt(torch.where(
                    mask, torch.full_like(power, STFT_FLOOR), power))

            sl.stft_magnitude = held
            try:
                return loss(x, y, fft_size, hop_size, win_length, all_sum)
            finally:
                sl.stft_magnitude = magnitude

        sl.stft_loss = pinned
        return self

    def __exit__(self, *exc):
        from aero_tpu_torch.losses import stft_loss as sl

        sl.stft_loss, sl.stft_magnitude = self.kept
        return False


CANONICAL = ["experiment=aero_4-16_512_64", "dset=4-16"]


def train_setup(precision, batch, overrides=()):
    """Models, TrainStep and bench.py's batch for the canonical
    experiment with ``overrides`` (``gan_setup``)."""
    return gan_setup(CANONICAL + list(overrides), precision, batch)[1:]


def train_gaps(attention, overrides=()):
    """One step's losses and generator gradient at batch 4 with the
    kernels against the plain attention under autograd: the losses, the
    whole gradient, and each LocalState leaf alone (the attention's
    gradient reaches the network behind DConv's 1e-3 LayerScale, so the
    whole gradient would hardly see a wrong backward); the canonical
    experiment with ``overrides``."""
    from aero_tpu_torch.models.modules import LocalState

    for precision, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
        models, step, lr, hr = train_setup(precision, 4, overrides)
        gen = models["generator"]
        names = [n for n, _ in gen.named_parameters()]
        # key.bias shifts every score of a query alike: its gradient is
        # zero but for rounding, so only the whole gradient holds it
        attn_leaves = [f"{m}.{n}" for m, mod in gen.named_modules()
                       if isinstance(mod, LocalState)
                       for n, _ in mod.named_parameters()
                       if n != "key.bias"]
        # float32 only: bfloat16's two runs part by far more than the
        # floor's rounding band, and its bounds dwarf a flip
        masks = {}
        pinned = (functools.partial(pinned_floors, masks)
                  if dtype == torch.float32 else contextlib.nullcontext)
        with pinned():
            g_k, _, m_k, _ = step.grads(lr, hr)
        with pinned() as pins:
            g_p, _, m_p, _ = forward_with(
                {(attention, "local_attention"): plain_attention(attention)},
                step.grads, lr, hr)
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
        log(f"train step B=4 {precision} {' '.join(overrides)}, kernels "
            "vs plain attention: "
            f"max relative loss gap {loss_gap:.3e} (< "
            f"{TRAIN_LOSS_GAP[dtype]:g}), generator gradient relative L2 "
            f"{grad_gap:.3e} (< {TRAIN_GRAD_GAP[dtype]:g}), each of "
            f"{len(leaf_gaps)} LocalState leaves relative L2 <= "
            f"{leaf_gaps[worst]:.3e} ({worst}; < "
            f"{TRAIN_ATTN_LEAF_GAP[dtype]:g}); "
            + (f"STFT floor sides replayed against the plain run's own: "
               f"{pins.flips} of {sum(m.size for m in masks.values())} bins"
               if pins else "STFT floors not pinned") + "; losses "
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
    """Phase 7 at batch 16 in bfloat16 (``gan_step``); returns the launch
    counts of one step (4 attention calls forward and 4 backward, each
    backward 2 kernels) and the median step time in ms."""
    models, step, lr, hr = train_setup("bfloat16", BATCH)
    return gan_step(attention, models, step, lr, hr, smi, "train", {
        "forward": 4, "forward_mma": 4, "backward": 8, "backward_mma": 8})


@contextlib.contextmanager
def wrapped(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` within the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


ATTENTION_COUNTS = {"forward": "launches", "forward_mma": "mma_launches",
                    "backward": "backward_launches",
                    "backward_mma": "backward_mma_launches"}


def attention_counts(attention):
    return {k: getattr(attention.local_attention, name)
            for k, name in ATTENTION_COUNTS.items()}


def zero_attention_counts(attention):
    for name in ATTENTION_COUNTS.values():
        setattr(attention.local_attention, name, 0)


def forward_kinds():
    """[eager forwards, graph captures, graph replays] of ``EvalForward``
    so far."""
    from aero_tpu_torch.eval.forward import EvalForward

    return [EvalForward.eager_forwards, EvalForward.graph_captures,
            EvalForward.graph_replays]


def graph_pool_bytes():
    """The bytes the caching allocator holds in CUDA graphs' private
    pools: its segments outside the default pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def recorder(attention, calls, sync=False, tag=None):
    """``make`` for ``wrapped``: each call of the wrapped function appends
    (wall seconds, its attention kernel launches, ``tag(args)`` taken at the
    call, or None) to ``calls``. Launches are the counters' difference across the
    call, so recorders nest."""
    def make(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            before = attention_counts(attention)
            label = tag(args) if tag else None
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            after = attention_counts(attention)
            calls.append((time.perf_counter() - t0,
                          {k: after[k] - before[k] for k in after}, label))
            return out
        return call
    return make


SOLVER_FILES, SOLVER_FILE_S = 40, 2.5
# the kernels that phase 9's profile=true trace of a bf16 step must name
PROFILED_KERNELS = ("local_attention_fwd_mma_kernel",
                    "local_attention_bwd_dq_mma_kernel",
                    "local_attention_bwd_dkv_mma_kernel")
# one fused-Adam update from the restored state against torch's plain
# single-tensor Adam on the CPU, same state and gradient: of max |update|,
# beyond one float32 ulp of each updated parameter
ADAM_UPDATE_TOL = 1e-4


def adam_states(train_step):
    """{optimizer: [(parameter, {step, exp_avg, exp_avg_sq} cloned)]} of
    a ``TrainStep``'s Adams, in parameter order."""
    return {name: [(p, {k: v.clone() for k, v in opt.state[p].items()})
                   for g in opt.param_groups for p in g["params"]
                   if p in opt.state]
            for name, opt in (("generator", train_step.gen_opt),
                              ("discriminators", train_step.disc_opt))
            if opt is not None}


def check_restored_adam(saved, restored):
    """Raise unless every parameter's restored Adam state equals the state
    saved at the end of the first run bit for bit, lies as the fused Adam
    needs it (step a float32 scalar on the parameter's device, moments in
    the parameter's dtype, device and strides), and gives the same update
    under the fused Adam as under the plain one. Returns the worst gap of
    the updated parameters (of max |update|) and the number of parameters
    checked."""
    worst, n = 0.0, 0
    for name, entries in restored.items():
        if len(entries) != len(saved[name]) or not entries:
            raise AssertionError(f"{name} Adam: {len(entries)} restored "
                                 f"states, {len(saved[name])} saved")
        for (p, st), (_, want) in zip(entries, saved[name]):
            for key in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(st[key].cpu(), want[key].cpu()):
                    raise AssertionError(f"{name} Adam {key} differs from "
                                         "the saved state")
            if st["step"].dtype != torch.float32 or \
                    st["step"].device != p.device or st["step"].dim():
                raise AssertionError(f"{name} Adam step {st['step']!r}")
            for key in ("exp_avg", "exp_avg_sq"):
                m = st[key]
                if (m.dtype, m.device, m.stride()) != (
                        p.dtype, p.device, p.stride()):
                    raise AssertionError(f"{name} Adam {key} layout")
            n += 1
        params = [p for p, _ in entries]
        gen = torch.Generator().manual_seed(5)
        grads = [1e-2 * torch.randn(p.shape, generator=gen) for p in params]
        hyper = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8)
        updated = []
        for device, extra in ((params[0].device, {"fused": True}),
                              ("cpu", {"foreach": False})):
            ps = [torch.nn.Parameter(p.detach().to(device, copy=True))
                  for p in params]
            opt = torch.optim.Adam(ps, **hyper, **extra)
            for q, (_, st), g in zip(ps, entries, grads):
                q.grad = torch.empty_like(q).copy_(g)  # q's strides
                opt.state[q] = {k: v.to(device, copy=True)
                                for k, v in st.items()}
            opt.step()
            updated.append([q.detach().cpu() for q in ps])
        top = max(float((b.double() - p.detach().cpu().double()).abs().max())
                  for b, p in zip(updated[1], params))
        for a, b in zip(*updated):
            # each side rounds p + update to float32: one ulp of the result
            # apart is rounding, not a different update
            ulp = (torch.nextafter(b.abs(), torch.tensor(math.inf))
                   - b.abs()).double()
            gap = (a.double() - b.double()).abs()
            if bool((gap > ADAM_UPDATE_TOL * top + ulp).any()):
                raise AssertionError(
                    f"{name}: fused Adam update from the restored state off "
                    f"by {float(gap.max()):.3e} of {top:.3e}")
            worst = max(worst, float(gap.max()) / top)
    return worst, n


def solver(attention, smi):
    """Phase 9: the Solver slice at the canonical width through its CLIs,
    in this process (``main`` of ``python -m aero_tpu_torch.train``,
    ``aero_tpu_torch.test`` and ``aero_tpu_torch.predict``): a dummy
    dataset of 40 files of 2.5-2.75 s; train 2 epochs at batch 16 x 2 s in
    bfloat16 with cross-validation on the test files every epoch and the
    evaluation (LSD) at the end; resume for a third epoch; the test CLI
    and the predict CLI from checkpoint.atpu. Returns the attention kernel
    launches of the whole phase."""
    from aero_tpu_torch import predict
    from aero_tpu_torch import test as test_cli
    from aero_tpu_torch.data.prep import make_dummy_dataset
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.aero import Aero
    from aero_tpu_torch.train import __main__ as train_cli
    from aero_tpu_torch.train import checkpoint
    from aero_tpu_torch.train import solver as solver_mod
    from aero_tpu_torch.train.solver import Solver
    from aero_tpu_torch.train.train_step import TrainStep

    (steps, forwards, serves, epochs, valids, losses, scores, evals, saves,
     loads) = ([] for _ in range(10))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        os.chdir(tmp)
        st.callback(os.chdir, cwd)
        make_dummy_dataset(os.path.join(tmp, "egs"), n_files=SOLVER_FILES,
                           duration=SOLVER_FILE_S, seed=0)
        for owner, name, calls, sync, tag in (
                (TrainStep, "__call__", steps, True, None),
                # the generator's mode at the call: train or eval
                (Aero, "forward", forwards, False, lambda a: a[0].training),
                (Solver, "_run_one_epoch", epochs, True, lambda a: a[1]),
                (Solver, "_valid_on_test_data", valids, True, None),
                (Solver, "valid_losses", losses, True, None),
                (solver_mod, "evaluate_on_saved_data", scores, True, None),
                (test_cli, "evaluate", evals, True, None),
                (checkpoint, "save_package", saves, True, None),
                (checkpoint, "load_package", loads, True, None)):
            st.enter_context(wrapped(owner, name, recorder(
                attention, calls, sync, tag)))

        def serve_recorder(fn):
            """Each eval-mode forward (``EvalForward._forward``, a CUDA
            graph's replay included): its attention launches, its
            [eager, captured, replayed] forwards, and after it the bytes
            of the graphs' pools and all the allocator reserves."""
            @functools.wraps(fn)
            def call(*args, **kwargs):
                launched, kinds = attention_counts(attention), forward_kinds()
                out = fn(*args, **kwargs)
                after = attention_counts(attention)
                serves.append((
                    {k: after[k] - launched[k] for k in after},
                    [a - b for a, b in zip(forward_kinds(), kinds)],
                    graph_pool_bytes(), torch.cuda.memory_reserved()))
                return out
            return call

        st.enter_context(wrapped(EvalForward, "_forward", serve_recorder))
        cli = ["experiment=aero_4-16_512_64", "dset=4-16",
               "precision=bfloat16", "device=cuda", "visqol=false",
               f"dset.train={tmp}/egs/tr", f"dset.valid={tmp}/egs/val",
               f"dset.test={tmp}/egs/val"]
        train = cli + ["cross_valid=true", "cross_valid_every=1",
                       "eval_every=2"]
        run_dir = os.path.join(tmp, "outputs", "4-16", "aero-nfft=512-hl=64")
        # the Adam states at the end of the first run, and as the resumed
        # run restored them from checkpoint.atpu (before its first step)
        adam_saved, adam_restored = [], []

        def after(calls, method):
            def make(fn):
                @functools.wraps(fn)
                def call(self, *args, **kwargs):
                    out = fn(self, *args, **kwargs)
                    states = adam_states(self.train_step)
                    if any(states.values()):
                        calls.append(states)
                    return out
                return call
            st.enter_context(wrapped(Solver, method, make))

        after(adam_saved, "train")
        after(adam_restored, "_reset")

        zero_attention_counts(attention)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = train_cli.main(train + ["epochs=2", "profile=true"])
        t_train = time.perf_counter() - t0
        traces = glob.glob(os.path.join(run_dir, "profile",
                                        "*.pt.trace.json"))
        text = ""
        for path in traces:
            with open(path) as f:
                text += f.read()
        traced = {k: k in text for k in PROFILED_KERNELS}
        first_epochs = [e[2] for e in epochs]
        n_first = len(steps)
        history = train_cli.main(train + ["epochs=3"])
        resumed = [e[2] for e in epochs][len(first_epochs):]
        if len(adam_saved) != 2 or len(adam_restored) != 1:
            raise AssertionError(f"Adam states: {len(adam_saved)} saved, "
                                 f"{len(adam_restored)} restored")
        adam_gap, adam_n = check_restored_adam(adam_saved[0],
                                               adam_restored[0])
        del adam_saved[:], adam_restored[:]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_valid_fwd = len(serves)
        results = test_cli.main(cli)
        n_test_fwd = len(serves) - n_valid_fwd
        wav = os.path.join(tmp, "chirp12.wav")
        n_in = write_test_wav(wav, 12.3)
        out = predict.main(cli + [f"+filename={wav}",
                                  f"+output={tmp}/predicted"])
        launches = attention_counts(attention)
        with open(os.path.join(run_dir, "history.json")) as f:
            on_disk = json.load(f)
        samples = sorted(os.listdir(os.path.join(run_dir, "samples")))
        best = os.path.exists(os.path.join(run_dir, "best.atpu"))

    train_fwd = [c for c in forwards if c[2]]
    eval_fwd = serves
    step_s = [c[0] for c in steps]
    log(f"solver: train CLI 2 epochs {t_train:.1f} s, {n_first} steps of "
        f"B=16 x 2 s bf16; epochs {first_epochs} then resumed {resumed}; "
        f"history {len(history)} entries ({len(on_disk)} on disk), best.atpu "
        f"{best}, {len(samples)} sample files")
    log(f"solver: epoch time {', '.join(f'{e[0]:.2f}' for e in epochs)} s; "
        f"median step {statistics.median(step_s) * 1e3:.1f} ms (of "
        f"{len(step_s)}: {', '.join(f'{t * 1e3:.0f}' for t in step_s)}); "
        f"peak memory {peak:.2f} GiB [{smi}]")
    def per_file(calls):
        return ", ".join(f"{c[0]:.2f} s ({c[0] / SOLVER_FILES * 1e3:.1f} ms "
                         "a file)" for c in calls)

    log(f"solver: {SOLVER_FILES} files: valid on the test files (with "
        f"enhance on epochs 2 and 3) {per_file(valids)}; scoring the saved "
        f"files {per_file(scores)}; test CLI evaluate {per_file(evals)}; "
        f"valid losses alone (of the valid files above) median "
        f"{statistics.median(c[0] for c in losses) * 1e3:.1f} ms a file "
        f"({len(losses)} files); "
        f"eval-mode forwards: train CLI {n_valid_fwd}, test CLI "
        f"{n_test_fwd}, all {len(eval_fwd)} (eager, captured, replayed "
        f"{[sum(c[1][i] for c in eval_fwd) for i in range(3)]}); graph "
        f"pools up to {max(c[2] for c in eval_fwd) / 2 ** 20:.1f} MiB, "
        f"reserved up to {max(c[3] for c in eval_fwd) / 2 ** 30:.2f} GiB "
        f"after an eval-mode forward; train forwards {len(train_fwd)} "
        f"[{smi}]")
    log(f"solver: checkpoint save {', '.join(f'{c[0]:.2f}' for c in saves)} "
        f"s, load {', '.join(f'{c[0]:.2f}' for c in loads)} s; resumed Adam "
        f"state of {adam_n} parameters equal to the saved one, fused update "
        f"from it vs plain Adam {adam_gap:.2e} of max |update| (tolerance "
        f"{ADAM_UPDATE_TOL:g} of it plus one float32 ulp of the parameter)")
    log(f"solver: profile=true traced step 1 of epoch 0 into {len(traces)} "
        f"file(s) under profile/, naming {traced}")
    log(f"solver: test CLI {results}; predict CLI {n_in} -> "
        f"{out['out_samples']} samples, realtime factor "
        f"{out['realtime_factor']:.1f}x; attention launches {launches}")

    if len(traces) != 1 or not all(traced.values()):
        raise AssertionError(f"profile=true: {len(traces)} traces, kernels "
                             f"named {traced}")
    want_step = {"forward": 4, "forward_mma": 4, "backward": 8,
                 "backward_mma": 8}
    bad = [c[1] for c in steps if c[1] != want_step]
    if bad or len(steps) != 15:
        raise AssertionError(f"train steps: {len(steps)} (want 15), launches "
                             f"per step not {want_step}: {bad[:3]}")
    # 4 launches, all mma, for each eager forward and each capture (a
    # pool's first capture also runs its floor's), none for a replay
    bad = [c for c in eval_fwd if c[0] != dict(
        forward=4 * (c[1][0] + c[1][1]), forward_mma=4 * (c[1][0] + c[1][1]),
        backward=0, backward_mma=0)]
    if bad or n_valid_fwd != 3 * SOLVER_FILES or n_test_fwd != SOLVER_FILES:
        raise AssertionError(f"eval-mode forwards: train CLI {n_valid_fwd} "
                             f"(want {3 * SOLVER_FILES}), test CLI "
                             f"{n_test_fwd} (want {SOLVER_FILES}); launches "
                             f"not 4 an eager forward or capture: {bad[:3]}")
    numbers = [v for h in history for v in h.values()
               if isinstance(v, (int, float))]
    if not (len(history) == len(on_disk) == 3 and all(
            math.isfinite(v) for v in numbers) and math.isfinite(
            results["lsd"]) and results["lsd"] > 0):
        raise AssertionError(f"history or metrics wrong: {history}, "
                             f"{results}")
    if first_epochs != [0, 1] or resumed != [2] or not best:
        raise AssertionError(f"epochs {first_epochs}, resumed {resumed} "
                             f"(want [2]), best.atpu {best}")
    stems = {f.rsplit("_", 1)[0] for f in samples if f.endswith("_pr.wav")}
    if len(stems) != SOLVER_FILES or not all(
            f"{s}_{k}" in samples for s in stems
            for k in ("lr.wav", "hr.wav", "pr.wav", "pr_spec.png")):
        raise AssertionError(f"sample triples missing: {samples[:8]}")
    if out["out_samples"] != 4 * n_in:
        raise AssertionError("predict output is not 4x the input")
    return launches


HIFI = ["experiment=aero_4-16_512_64", "dset=4-16",
        "experiment.discriminator_models=[hifi]"]
SEANET = ["experiment=seanet_4-16", "dset=4-16"]
CARD_CPU_TOL = 1e-4  # float32 card vs CPU, relative (L2 for tensors)


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convolutions without TF32, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def gan_setup(overrides, precision, batch):
    """Config, models on the card, TrainStep and bench.py's batch of
    ``batch`` segments (0.1 N(0, 1) from default_rng(0), lr then hr)."""
    from aero_tpu_torch.train.build import build_models, segment_shapes
    from aero_tpu_torch.train.train_step import TrainStep
    from aero_tpu_torch.utils.config import load_config

    args = load_config(CONF, "main_config",
                       overrides + [f"precision={precision}"])
    args.experiment.batch_size = batch
    models = build_models(args, "cuda", seed=0)
    lr_shape, hr_shape = segment_shapes(args.experiment)
    rng = np.random.default_rng(0)
    lr = (0.1 * rng.standard_normal(lr_shape)).astype(np.float32)
    hr = (0.1 * rng.standard_normal(hr_shape)).astype(np.float32)
    return args, models, TrainStep(args, models, "cuda"), lr, hr


def hifi_card_vs_cpu():
    """The HiFi losses (the train step's LossComputer, storing call
    included) and the discriminators' gradient of the canonical MPD and
    MSD at B = 2 x 0.5 s in float32, the card against the CPU, TF32 off,
    each network's gradient held on its own. A float64 run on the CPU
    (the discriminator pass alone; only the loss terms' float32 casts
    stay) is the witness that says which float32 side is off, and where."""
    from aero_tpu_torch.models.discriminators import SNConv1d
    from aero_tpu_torch.models.factory import build_discriminators
    from aero_tpu_torch.train.train_step import LossComputer
    from aero_tpu_torch.utils.config import load_config

    args = load_config(CONF, "main_config", HIFI)
    rng = np.random.default_rng(3)
    hr, pr = ((0.1 * rng.standard_normal((2, 1, 8000))).astype(np.float32)
              for _ in range(2))
    sides = {}
    with no_tf32():
        for side, device, dtype in (("cpu", "cpu", torch.float32),
                                    ("cuda", "cuda", torch.float32),
                                    ("f64", "cpu", torch.float64)):
            models = build_discriminators(args.experiment, "float32", device,
                                          seed=0)
            if dtype == torch.float64:
                for m in models.values():
                    m.double()
                    for sub in m.modules():
                        if hasattr(sub, "compute_dtype"):
                            sub.compute_dtype = dtype
            lc = LossComputer(args, models)
            h, p = (torch.from_numpy(a).to(device, dtype) for a in (hr, pr))
            real = lc.real_outputs(h)
            losses = {} if side == "f64" else lc.generator_losses(p, h, real)
            disc = lc.discriminator_losses(p, real, store=True)
            losses.update({f"discriminator_{k}": v for k, v in disc.items()})
            params = {n: list(m.named_parameters())
                      for n, m in models.items()}
            grads = torch.autograd.grad(
                sum(disc.values()), [q for ps in params.values()
                                     for _, q in ps])
            leaves, i = {}, 0
            for n, ps in params.items():
                leaves[n] = {k: g.double().cpu() for (k, _), g in
                             zip(ps, grads[i:i + len(ps)])}
                i += len(ps)
            us = [m.weight_u for m in models["msd_hifi"].modules()
                  if isinstance(m, SNConv1d)]
            sides[side] = ({k: float(v.detach()) for k, v in losses.items()},
                           leaves, torch.cat(us).double().cpu())
    (l_cpu, g_cpu, u_cpu), (l_gpu, g_gpu, u_gpu) = sides["cpu"], sides["cuda"]
    g_64 = sides["f64"][1]
    loss_gap = max(abs(l_gpu[k] - l_cpu[k]) / abs(l_cpu[k]) for k in l_cpu)

    def flat(leaves):
        return torch.cat([g.flatten() for g in leaves.values()])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    gaps, witness = {}, {}
    for n in g_cpu:
        gaps[n] = rel(flat(g_gpu[n]), flat(g_cpu[n]))
        worst = {}
        for side, g in (("card", g_gpu), ("CPU", g_cpu)):
            per_leaf = {k: rel(g[n][k], w) for k, w in g_64[n].items()}
            k = max(per_leaf, key=per_leaf.get)
            worst[side] = (rel(flat(g[n]), flat(g_64[n])), k, per_leaf[k])
        witness[n] = worst
    u_gap = float((u_gpu - u_cpu).abs().max())
    log(f"hifi card vs CPU, float32 without TF32, B=2 x 0.5 s: losses "
        + ", ".join(f"{k} {v:.5f}" for k, v in l_gpu.items())
        + f"; max relative loss gap {loss_gap:.3e}, stored u max gap "
        f"{u_gap:.3e}; discriminator gradient relative L2 per network "
        + ", ".join(f"{n} {v:.3e}" for n, v in gaps.items())
        + f" (each < {CARD_CPU_TOL:g})")
    for n, worst in witness.items():
        log(f"  {n} gradient against the float64 CPU witness: "
            + "; ".join(f"{side} {g:.3e} (worst leaf {k} {v:.3e})"
                        for side, (g, k, v) in worst.items())
            + f" (card < {CARD_CPU_TOL:g})")
    if not (set(l_gpu) == set(l_cpu) and loss_gap < CARD_CPU_TOL
            and all(v < CARD_CPU_TOL for v in gaps.values())
            and all(w["card"][0] < CARD_CPU_TOL for w in witness.values())
            and u_gap < CARD_CPU_TOL):
        raise AssertionError("hifi losses or gradient on the card disagree "
                             "with the CPU or the float64 witness")


def gan_step(attention, models, step, lr, hr, smi, what, want_launches):
    """One checked step and then 2 warm-ups and the median of 5 timed
    steps and a profiled one, each step's attention kernel launches read
    with the counters set to 0 just before it. Raises unless every step
    launched ``want_launches``, every loss is finite, every network
    changed in the first step and each stored spectral-norm u is finite
    and moved. Returns the first step's launches and the median step time
    in ms."""
    from aero_tpu_torch.models.discriminators import SNConv1d

    n_params = {n: sum(p.numel() for p in m.parameters())
                for n, m in models.items()}
    before = {n: [p.detach().clone() for p in m.parameters()]
              for n, m in models.items()}
    sn = [m for d in models.values() for m in d.modules()
          if isinstance(m, SNConv1d)]
    u_before = [m.weight_u.clone() for m in sn]
    steps = []

    def counted():
        zero_attention_counts(attention)
        metrics = step(lr, hr)
        torch.cuda.synchronize()
        steps.append(attention_counts(attention))
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{what}: non-finite metrics {metrics}")
        return metrics

    metrics = counted()
    log(f"{what} step B={BATCH} x 2 s bf16 ({n_params} params): metrics "
        + ", ".join(f"{n} {v:.5f}" for n, v in metrics.items())
        + f"; attention kernel launches {steps[0]}")
    for name, model in models.items():
        moved = max(float((p.detach() - q).abs().max())
                    for p, q in zip(model.parameters(), before[name]))
        log(f"  {name}: largest weight change {moved:.3e}")
        if not moved > 0:
            raise AssertionError(f"{what}: {name} weights did not change")
    del before
    u_moved = [float((m.weight_u - u).abs().max())
               for m, u in zip(sn, u_before)]
    if sn:
        log(f"  {len(sn)} spectral-norm u: smallest change "
            f"{min(u_moved):.3e}, all finite "
            f"{all(bool(torch.isfinite(m.weight_u).all()) for m in sn)}")
    if not all(d > 0 for d in u_moved) or not all(
            bool(torch.isfinite(m.weight_u).all()) for m in sn):
        raise AssertionError(f"{what}: a stored u did not move or is not "
                             "finite")
    for _ in range(2):
        counted()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        counted()
        runs.append(time.perf_counter() - t0)
    med = statistics.median(runs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{what} step B={BATCH} x 2 s bf16: {med * 1e3:.1f} ms (median of "
        f"{len(runs)}: {', '.join(f'{r * 1e3:.1f}' for r in runs)}), "
        f"throughput {BATCH * 2 / med:.1f} audio-s/s, peak memory "
        f"{peak:.2f} GiB [{smi}]")
    device_profile(counted, f"{what} step B={BATCH}", smi)
    bad = [c for c in steps if c != want_launches]
    if bad:
        raise AssertionError(f"{what}: expected attention launches "
                             f"{want_launches} in each of {len(steps)} "
                             f"steps, got {bad[:3]}")
    return steps[0], med * 1e3


def hifi_seanet(attention, lstm, ftb, smi):
    """Phase 10: the HiFi train step and Seanet's step, serving and
    predict CLI at the canonical widths. Returns the attention kernel
    launches of one HiFi step."""
    from aero_tpu_torch import predict
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.factory import build_generator
    from aero_tpu_torch.train import checkpoint

    hifi_card_vs_cpu()
    _, models, step, lr, hr = gan_setup(HIFI, "bfloat16", BATCH)
    hifi_launches, _ = gan_step(attention, models, step, lr, hr, smi, "hifi", {
        "forward": 4, "forward_mma": 4, "backward": 8, "backward_mma": 8})
    del models, step
    torch.cuda.empty_cache()

    args, models, step, lr, hr = gan_setup(SEANET, "bfloat16", BATCH)
    gan_step(attention, models, step, lr, hr, smi, "seanet", {
        "forward": 0, "forward_mma": 0, "backward": 0, "backward_mma": 0})
    del models, step
    torch.cuda.empty_cache()

    kwargs = dict(args.experiment.seanet)
    with no_tf32():
        gen32 = build_generator(kwargs, "float32", "cpu", seed=0,
                                model="seanet")
        x = (0.1 * np.random.default_rng(4).standard_normal(
            (1, 1, SECONDS * LR_SR))).astype(np.float32)
        with torch.no_grad():
            want = gen32(torch.from_numpy(x)).numpy()
            got = gen32.to("cuda")(torch.from_numpy(x).cuda()).cpu().numpy()
    gap = rel_l2(got, want)
    log(f"seanet forward {SECONDS} s, float32 without TF32, card vs CPU: "
        f"relative L2 {gap:.3e} (< {CARD_CPU_TOL:g})")
    if not gap < CARD_CPU_TOL:
        raise AssertionError("seanet forward on the card disagrees with the "
                             "CPU")
    del gen32

    gen = build_generator(kwargs, "bfloat16", "cuda", seed=0, model="seanet")
    log(f"seanet: seanet_4-16, {sum(p.numel() for p in gen.parameters())} "
        "params, bf16 compute")
    fwd = EvalForward(gen, scale=HR_SR / LR_SR, lr_sr=LR_SR, device="cuda")
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (BATCH, 1, SECONDS * LR_SR))).astype(np.float32)
    checked_forward(fwd, x, (attention, lstm, ftb), {
        "attention": 0, "attention_mma": 0, "banded": 0, "lstm": 0,
        "lstm_mma": 0, "ftb": 0, "ftb_mma": 0})
    realtime_factor(fwd, x, smi, "seanet")
    device_profile(lambda: fwd(x), f"seanet forward B={BATCH}", smi)

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            ckpt = os.path.join(tmp, "seanet.atpu")
            t0 = time.perf_counter()
            checkpoint.save_package(ckpt, {"models": checkpoint.
                                           model_variables({"generator": gen})})
            log(f"seanet .atpu written in {time.perf_counter() - t0:.2f} s")
            wav = os.path.join(tmp, "chirp35.wav")
            n_in = write_test_wav(wav, 35)
            out = predict.main(SEANET + [
                f"+filename={wav}", f"+output={tmp}/out",
                f"checkpoint_file={ckpt}", "precision=bfloat16",
                "device=cuda"])
        finally:
            os.chdir(cwd)
    log(f"seanet predict CLI (main): 35 s file, {n_in} -> "
        f"{out['out_samples']} samples, realtime factor "
        f"{out['realtime_factor']:.1f}x [{smi}]")
    if out["out_samples"] != 4 * n_in:
        raise AssertionError("seanet predict output is not 4x the input")
    return hifi_launches


DCONV3 = {"dconv_mode": 3}
TIME_GELU = {"freq_ends": 2, "act_func": "gelu"}
NFREQS_TOL = 1e-4  # float32 card vs CPU, relative L2 (TF32 off)


def forward_shapes(attention, shapes):
    """``wrapped`` that appends the folded (rows, T, C') of each forward
    kernel launch to ``shapes``."""
    def make(fn):
        @functools.wraps(fn)
        def call(qf, *args, **kwargs):
            shapes.append(tuple(qf.shape))
            return fn(qf, *args, **kwargs)
        return call
    return wrapped(attention, "_kernel_fwd", make)


def folded(shape):  # [B*F, T, H, C'] -> the kernel's (rows, T, C')
    b, t, h, c = shape
    return (b * h, t, c)


def serve_option(attention, lstm, ftb, smi, aero_kw, want_shapes,
                 optin=None):
    """One serving cell of phase 12: the canonical generator with
    ``aero_kw`` from the seeded init in bf16 at batch 16 x 10 s. One
    forward whose forward-kernel launches, all on the tensor cores, have
    ``want_shapes`` [B*F, T, H, C'], the whole-forward gap to the plain
    versions in bf16 and f32, with the opt-in switches one forward that
    must launch ``optin``, the realtime factor and the device ms of the
    program's spans.
    Returns the launches of the default and of the opt-in forward."""
    from aero_tpu_torch.eval.forward import EvalForward
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)

    what = " ".join(f"{k}={v}" for k, v in aero_kw.items())
    kwargs = dict(CANONICAL_AERO_4_16, **aero_kw)
    gen = build_generator(kwargs, "bfloat16", "cuda", seed=0)
    gen32 = build_generator(kwargs, "float32", "cuda", seed=0)
    log(f"generator: canonical with {what}, "
        f"{sum(p.numel() for p in gen.parameters())} params, bf16 compute")
    fwd, fwd32 = (EvalForward(g, scale=HR_SR / LR_SR, lr_sr=LR_SR,
                              device="cuda") for g in (gen, gen32))
    x = (0.1 * np.random.default_rng(0).standard_normal(
        (BATCH, 1, SECONDS * LR_SR))).astype(np.float32)
    counted = (attention, lstm, ftb)
    n = len(want_shapes)
    shapes = []
    with forward_shapes(attention, shapes):
        _, launches = checked_forward(fwd, x, counted, {
            "attention": n, "attention_mma": n, "banded": 0, "lstm": 0,
            "lstm_mma": 0, "ftb": 0, "ftb_mma": 0})
    want = sorted(folded(w) for w in want_shapes)
    log(f"  {what}: forward kernel launches at (rows, T, C') {shapes}")
    if sorted(shapes) != want:
        raise AssertionError(f"{what}: forward kernel shapes {shapes}, want "
                             f"{want}")
    forward_gaps(fwd, fwd32, x[:1], plain_swaps(*counted), what)
    del gen32, fwd32
    opt = None
    if optin is not None:
        with switches(OPT_IN):
            _, opt = checked_forward(fwd, x, counted, optin)
    realtime_factor(fwd, x, smi, what)
    profile_forward(fwd, x, smi, what)
    del gen, fwd
    torch.cuda.empty_cache()
    return launches, opt


def local_state_options(attention, smi):
    """Phase 12 (d): a LocalState with nfreqs 2 (the decoder of plan index
    2's width: 96 channels, 4 heads) on the card in f32 against the CPU,
    which must launch no kernel and take ``periodic_attention`` once; one
    with ndecay 0 in f32 and bf16, which must launch the forward kernel on
    its dtype's route and hold its plain version (GAP_F32, GAP_BF16)."""
    import copy

    from aero_tpu_torch.models.modules import LocalState

    n, c, t = 8, 96, 2501
    x = torch.from_numpy((0.5 * np.random.default_rng(9).standard_normal(
        (n, c, t))).astype(np.float32))
    torch.manual_seed(0)
    cpu = LocalState(c, nfreqs=2).eval()
    card = copy.deepcopy(cpu).cuda()
    with torch.no_grad():
        want = cpu(x).numpy()
        zero_attention_counts(attention)
        calls = attention.periodic_attention.calls
        got = card(x.cuda()).cpu().numpy()
    launched = attention_counts(attention)["forward"]
    calls = attention.periodic_attention.calls - calls
    nfreqs_gap = rel_l2(got, want)
    log(f"LocalState nfreqs=2 [N, C, T]=({n}, {c}, {t}) f32, card vs CPU: "
        f"relative L2 {nfreqs_gap:.3e} (< {NFREQS_TOL:g}); kernel launches "
        f"{launched}, periodic_attention calls {calls} [{smi}]")
    if not (nfreqs_gap < NFREQS_TOL and launched == 0 and calls == 1):
        raise AssertionError("LocalState nfreqs on the card")
    torch.manual_seed(1)
    module = LocalState(c, ndecay=0).cuda().eval()
    for dtype, tol in ((torch.float32, GAP_F32), (torch.bfloat16, GAP_BF16)):
        xd = x.cuda().to(dtype)
        with torch.no_grad():
            zero_attention_counts(attention)
            got = module(xd)
            launched = attention_counts(attention)
            want = forward_with({(attention, "local_attention"):
                                 plain_attention(attention)}, module, xd)
        gap = rel_l2(got.float().cpu().numpy(), want.float().cpu().numpy())
        mma = int(dtype == torch.bfloat16)
        log(f"LocalState ndecay=0 {str(dtype)[6:]}: kernel vs plain relative "
            f"L2 {gap:.3e} (< {tol:g}); launches {launched}")
        if not (gap < tol and launched["forward"] == 1
                and launched["forward_mma"] == mma):
            raise AssertionError(f"LocalState ndecay=0 {dtype}")


def predict_upsample(attention, smi):
    """Phase 12 (e): the predict CLI with ``experiment.upsample=true`` and
    ``experiment.aero.spec_upsample=false`` on the 35 s file from a
    reference .th of the seeded canonical generator: the input resampled
    to 16 kHz, the forward at scale 1, so the output has the resampled
    input's length; 2 runs (the warm-up, and the timed run, which
    captures the tail's CUDA graph after the pool's floor) of 3 batched
    chunks and the tail: 4 forward launches, all on the tensor cores, for
    each eager forward and each capture (``forward_kinds``), none for a
    replay."""
    from aero_tpu_torch import predict
    from aero_tpu_torch.data.resample import resample_np
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)
    from aero_tpu_torch.train.from_jax import save_reference_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "checkpoint.th")
        kwargs = dict(CANONICAL_AERO_4_16, spec_upsample=False)
        save_reference_checkpoint(ckpt, build_generator(
            kwargs, "bfloat16", "cuda", seed=0), kwargs)
        wav = os.path.join(tmp, "chirp35.wav")
        n_in = write_test_wav(wav, 35)
        zero_attention_counts(attention)
        kinds = forward_kinds()
        out = predict.main(CANONICAL + [
            f"+filename={wav}", f"+output={tmp}/out",
            f"checkpoint_file={ckpt}", "precision=bfloat16", "device=cuda",
            "experiment.upsample=true", "experiment.aero.spec_upsample=false"])
        launches = attention_counts(attention)
        kinds = [a - b for a, b in zip(forward_kinds(), kinds)]
    n_hr = resample_np(np.zeros(n_in, np.float32), LR_SR, HR_SR).shape[-1]
    want = 4 * (kinds[0] + kinds[1])
    log(f"predict CLI, upsample=true: 35 s file, {n_in} samples resampled to "
        f"{n_hr}, out {out['out_samples']} samples, realtime factor "
        f"{out['realtime_factor']:.1f}x (the timed run captures); forwards "
        f"eager, captured, replayed {kinds}; attention launches {launches} "
        f"(want {want}) [{smi}]")
    if not (out["in_samples"] == out["out_samples"] == n_hr
            and launches["forward"] == launches["forward_mma"] == want
            and kinds[2] == 0):
        raise AssertionError("predict with upsample=true")
    return out


def generator_options(attention, lstm, ftb, smi):
    """Phase 12: the generator options at the canonical width. (a) serving
    with dconv_mode 3: 8 forward launches, 2 each at enc2 (C' 12), enc3
    (24), the decoders of plan index 2 (24) and 3 (48); with the opt-in
    switches 12 LSTM launches (8 encoder, 4 decoder at H 96; none at
    H 192, which takes cuDNN), 8 banded and 4 FTB. (b) training with
    dconv_mode 3: phase 7's B = 4 gaps, then B = 16 x 2 s in bf16 with 8
    forward launches and 8 backward calls (16 kernels) a step. (c) serving
    with freq_ends 2 and GELU: enc3 and its decoder on the time axis, enc3's
    attention at T 1251. (d) LocalState with nfreqs and with ndecay 0.
    (e) predict with upsample=true. Returns the launch counts for the
    kernels' JSON."""
    out = {}
    out["serve_dconv3"], out["optin_dconv3"] = serve_option(
        attention, lstm, ftb, smi, DCONV3, [ENC2, ENC2, ENC3, ENC3, DEC2,
                                            DEC2, DEC3, DEC3],
        optin={"attention": 8, "attention_mma": 8, "banded": 8, "lstm": 12,
               "lstm_mma": 12, "ftb": 4, "ftb_mma": 4})
    train_gaps(attention, ["experiment.aero.dconv_mode=3"])
    models, step, lr, hr = train_setup("bfloat16", BATCH,
                                       ["experiment.aero.dconv_mode=3"])
    out["train_dconv3"], _ = gan_step(
        attention, models, step, lr, hr, smi, "train dconv_mode=3", {
            "forward": 8, "forward_mma": 8, "backward": 16,
            "backward_mma": 16})
    del models, step
    torch.cuda.empty_cache()
    out["serve_time_gelu"], _ = serve_option(
        attention, lstm, ftb, smi, TIME_GELU, [ENC2, ENC2, TIME_ENC3,
                                               TIME_ENC3])
    local_state_options(attention, smi)
    predict_upsample(attention, smi)
    return out


DDP_BATCH = 4  # the float32 step: 2 rows on each of 2 ranks
DDP_LOSS_TOL, DDP_GRAD_TOL = 1e-5, 1e-4  # relative; L2 for a gradient
# The canonical generator's float32 gradient moves by ~2.5e-4 relative L2
# at accum 2 when one process merely takes each microbatch's rows in
# another order (H100, TF32 off, the STFT floors pinned), above
# DDP_GRAD_TOL; so the ranks' gradient is held to this many times that
# rounding witness where the witness exceeds DDP_GRAD_TOL
DDP_WITNESS_FACTOR = 4
DDP_PREDICT_TOL = 1e-5  # float32, relative L2, split predict vs one device


def ddp_step(accum, rows, masks):
    """One float32 step (TF32 off) of the canonical generator and MelGAN
    from the seeded init at ``accum_steps = accum`` on ``rows`` of
    bench.py's batch of DDP_BATCH (a rank's rows under a group), on the
    STFT floors' sides of ``masks`` (``pinned_floors``). Returns (metrics,
    {network: its flattened gradient on the CPU}, the step's attention
    kernel launches, the weights' checksum after the update, the bins
    whose replayed side was not this run's own)."""
    from aero_tpu_torch import entry
    from aero_tpu_torch.ops import attention

    with no_tf32():
        args, models, step, lr, hr = gan_setup(
            ["experiment=aero_4-16_512_64", "dset=4-16",
             f"accum_steps={accum}"], "float32", DDP_BATCH)
        zero_attention_counts(attention)
        with pinned_floors(masks) as pins:
            gen, disc, metrics, stats = step.grads(rows(lr), rows(hr))
        step.apply(gen, disc, stats)
        torch.cuda.synchronize()
        counts = attention_counts(attention)
        grads = {n: torch.cat([g.flatten() for g in gs]).cpu()
                 for n, gs in (("generator", gen), ("msd_melgan", disc))}
        return (metrics, grads, counts, entry.weights_checksum(models),
                pins.flips)


def ddp_rank(accums, masks):
    """A rank of phase 11 (a): ``ddp_step`` on its rows at each accum, on
    the floors' sides ``masks[accum]`` of one process; the gradients from
    rank 0 alone (every rank holds the same)."""
    from aero_tpu_torch import entry
    from aero_tpu_torch.ops import _build
    from aero_tpu_torch.parallel import mesh

    _build.library()
    out = {}
    for accum in accums:
        metrics, grads, counts, checksum, flips = ddp_step(
            accum, entry.rank_rows, masks[accum])
        out[accum] = (metrics, grads if mesh.rank() == 0 else None, counts,
                      checksum, flips)
        del grads
        torch.cuda.empty_cache()
    return out


def nccl_rank(smi):
    """Phase 11 (b) in a one-rank NCCL group: bench.py's batch of 16 x 2 s
    in bfloat16, one checked step, 2 warm-ups and 5 timed steps, each
    step's attention launches read with the counters set to 0 before it,
    then a profiled step (the collectives' device time)."""
    import torch.distributed as dist

    from aero_tpu_torch.ops import _build, attention
    from aero_tpu_torch.parallel import mesh

    _build.library()
    _, models, step, lr, hr = gan_setup(
        ["experiment=aero_4-16_512_64", "dset=4-16"], "bfloat16", BATCH)
    launches, runs = [], []
    for i in range(8):
        zero_attention_counts(attention)
        t0 = time.perf_counter()
        metrics = step(lr, hr)
        torch.cuda.synchronize()
        if i >= 3:
            runs.append(time.perf_counter() - t0)
        launches.append(attention_counts(attention))
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"nccl step: non-finite metrics {metrics}")
    device_profile(lambda: step(lr, hr), f"nccl step B={BATCH}", smi)
    return {"backend": dist.get_backend(), "world": mesh.world_size(),
            "launches": launches, "runs_ms": [r * 1e3 for r in runs],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def ddp_gaps(metrics, grads, want_metrics, want_grads):
    loss = max(abs(metrics[k] - v) / abs(v) for k, v in want_metrics.items())
    grad = {n: float((grads[n] - g).norm() / g.norm())
            for n, g in want_grads.items()}
    return loss, grad


def data_parallel(smi, phase7_ms):
    """Phase 11: (a) 2 ranks on the card over gloo against one process,
    (b) the bfloat16 step under a one-rank NCCL group, (c) split predict.
    Returns the launches of (a)'s accum-1 step on each rank and of (b)'s
    first step."""
    import copy

    from aero_tpu_torch import entry, predict
    from aero_tpu_torch.data import audio_io
    from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)
    from aero_tpu_torch.train.from_jax import save_reference_checkpoint

    accums = (1, 2)
    one, alone, swapped = {}, {}, {}
    masks = {accum: {} for accum in accums}
    for accum in accums:  # one process records the floors' sides
        one[accum] = ddp_step(accum, lambda x: x, masks[accum])
        # the control on its own sides: its rows' power is not the
        # whole batch's, so a replayed side would not be a rounding's
        alone[accum] = ddp_step(accum, lambda x: x[:DDP_BATCH // 2], {})
        # the rounding witness: the same rows of each microbatch in
        # another order, which changes nothing but the order of sums
        swapped[accum] = ddp_step(accum, lambda x: x[[1, 0, 3, 2]],
                                  masks[accum])
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = entry.spawn(ddp_rank, [(accums, masks)] * 2, device="cuda",
                        backend="gloo", threads=0, timeout_s=400)
    log(f"ddp (a): 2 ranks on {torch.cuda.get_device_name(0)} over gloo, "
        f"{time.perf_counter() - t0:.1f} s with start-up [{smi}]")
    for accum in accums:
        want_metrics, want_grads = one[accum][:2]
        metrics, grads = ranks[0][accum][:2]
        loss, grad = ddp_gaps(metrics, grads, want_metrics, want_grads)
        c_loss, c_grad = ddp_gaps(alone[accum][0], alone[accum][1],
                                  want_metrics, want_grads)
        w_loss, w_grad = ddp_gaps(swapped[accum][0], swapped[accum][1],
                                  want_metrics, want_grads)
        bound = {n: max(DDP_GRAD_TOL, DDP_WITNESS_FACTOR * v)
                 for n, v in w_grad.items()}
        counts = [r[accum][2] for r in ranks]
        sums = {r[accum][3] for r in ranks}
        log(f"ddp (a) accum {accum}, B={DDP_BATCH} x 2 s float32, 2 ranks "
            f"vs one process: max relative loss gap {loss:.3e} (< "
            f"{DDP_LOSS_TOL:g}), gradient relative L2 "
            + ", ".join(f"{n} {v:.3e}" for n, v in grad.items())
            + " (< " + ", ".join(f"{v:.3e}" for v in bound.values())
            + f": {DDP_GRAD_TOL:g} or {DDP_WITNESS_FACTOR}x the witness); "
            f"weights equal across ranks "
            f"{len(sums) == 1}; attention launches per rank {counts}; STFT "
            f"floor sides replayed against a run's own: ranks "
            f"{[r[accum][4] for r in ranks]}, witness {swapped[accum][4]} of "
            f"{sum(m.size for m in masks[accum].values())} bins; control, "
            f"rank 0's rows alone: loss gap {c_loss:.3e}, gradient "
            + ", ".join(f"{n} {v:.3e}" for n, v in c_grad.items())
            + f"; the witness, one process with each microbatch's rows "
            f"swapped: loss gap {w_loss:.3e}, gradient "
            + ", ".join(f"{n} {v:.3e}" for n, v in w_grad.items()))
        if not (loss < DDP_LOSS_TOL and all(
                grad[n] < bound[n] for n in grad) and len(sums) == 1
                and all(c["forward"] == 4 * accum and c["backward"] == 8 * accum
                        for c in counts)
                and c_loss > 10 * DDP_LOSS_TOL
                and c_grad["generator"] > 10 * bound["generator"]):
            raise AssertionError(f"ddp (a) accum {accum}: the 2-rank step "
                                 "is not the one-process step")
    gloo_launches = [r[1][2] for r in ranks]
    del one, alone, swapped, masks, ranks
    torch.cuda.empty_cache()

    nccl = entry.spawn(nccl_rank, [(smi,)], device="cuda", backend="nccl",
                       threads=0, timeout_s=400)[0]
    med = statistics.median(nccl["runs_ms"])
    log(f"ddp (b): bf16 step B={BATCH} x 2 s under a {nccl['world']}-rank "
        f"{nccl['backend']} group: {med:.1f} ms (median of "
        f"{len(nccl['runs_ms'])}: "
        + ", ".join(f"{r:.1f}" for r in nccl["runs_ms"])
        + f"), phase 7 without a group {phase7_ms:.1f} ms; peak memory "
        f"{nccl['peak_gib']:.2f} GiB; attention launches {nccl['launches'][0]}"
        f" [{smi}]")
    want = {"forward": 4, "forward_mma": 4, "backward": 8, "backward_mma": 8}
    if nccl["backend"] != "nccl" or any(c != want for c in nccl["launches"]):
        raise AssertionError(f"ddp (b): launches {nccl['launches'][:3]}")

    with tempfile.TemporaryDirectory() as tmp:
        wav = os.path.join(tmp, "chirp35.wav")
        n_in = write_test_wav(wav, 35)
        x = audio_io.load(wav)[0][None]
        gaps = {}
        for precision in ("float32", "bfloat16"):
            with no_tf32():
                gen = build_generator(CANONICAL_AERO_4_16, precision, "cuda",
                                      seed=0)

                def fwd(model):
                    return EvalForward(model, scale=HR_SR / LR_SR,
                                       lr_sr=LR_SR, device="cuda")

                kw = dict(segment_s=10, batch_chunks=True,
                          scale=HR_SR / LR_SR)
                y_one = ChunkedInference(fwd(gen), LR_SR, **kw)(x)
                y_split = ChunkedInference(fwd(gen), LR_SR, replicas=[
                    fwd(gen), fwd(copy.deepcopy(gen))], **kw)(x)
            gaps[precision] = rel_l2(y_split, y_one)
            del gen
        ckpt = os.path.join(tmp, "gen.th")
        save_reference_checkpoint(ckpt, build_generator(
            CANONICAL_AERO_4_16, "float32", "cpu", seed=0),
            CANONICAL_AERO_4_16)
        out = predict.main([
            "experiment=aero_4-16_512_64", "dset=4-16", f"+filename={wav}",
            f"+output={tmp}/out", f"checkpoint_file={ckpt}",
            "precision=bfloat16", "device=cuda", "+devices=[cuda:0,cuda:0]"])
    log(f"ddp (c): 35 s predict split over [cuda:0, cuda:0] vs one device, "
        f"relative L2: float32 {gaps['float32']:.3e} (< {DDP_PREDICT_TOL:g}),"
        f" bfloat16 {gaps['bfloat16']:.3e}; the predict CLI with "
        f"+devices=[cuda:0,cuda:0]: {n_in} -> {out['out_samples']} samples, "
        f"realtime factor {out['realtime_factor']:.1f}x [{smi}]")
    if not (gaps["float32"] < DDP_PREDICT_TOL
            and out["out_samples"] == 4 * n_in):
        raise AssertionError("ddp (c): split predict disagrees with one "
                             "device")
    return {"gloo": gloo_launches, "nccl": nccl["launches"][0]}


@functools.lru_cache(maxsize=None)
def exp_rate() -> float:
    """Exponentials per second of the card's special-function units: 16
    a clock per SM at the max SM clock nvidia-smi reports."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_SM_CLOCK * sms * mhz * 1e6


def roof(flops, nbytes, exps=0):
    """(ms, 'bytes', 'operations' or 'exp'): the largest of ``flops`` at
    the bf16 tensor peak, ``nbytes`` at the HBM bandwidth and ``exps``
    exponentials at the special-function units' rate."""
    times = {"operations": flops / PEAK_BF16_FLOPS,
             "bytes": nbytes / PEAK_HBM_BYTES,
             "exp": exps / exp_rate() if exps else 0.0}
    by = max(times, key=times.get)
    return 1e3 * times[by], by


def bound(shape, backward: bool, with_lse: bool):
    """(ms, 'bytes', 'operations' or 'exp'): the least time of one call
    in bf16: 4 * C' FLOP per (query, key) pair forward, 8 * C' backward,
    against the bf16 tensor peak; one exponential per pair (p, or its
    recomputation from the lse) against the special-function units; each
    input read and each output written once, against HBM bandwidth."""
    b, t, h, c = shape
    rows = b * h
    flops = (8 if backward else 4) * c * rows * t * t
    tensor, vector = rows * t * c * 2, rows * t * 4  # bf16 [r,T,C], f32 [r,T]
    if backward:  # q k v out g, w lse in; dq dk dv, dw out
        nbytes = 8 * tensor + 3 * vector
    else:         # q k v, w in; out (and lse) out
        nbytes = 4 * tensor + (2 if with_lse else 1) * vector
    return roof(flops, nbytes, rows * t * t)


def banded_bound(shape, band):
    """The banded forward (no lse) in bf16: 4 * C' FLOP and one
    exponential per (query, key) pair inside the band, which this T and W
    give; q, k, v, w in, out."""
    b, t, h, c = shape
    s = np.arange(t)
    pairs = int((np.minimum(t - 1, s + band) - np.maximum(0, s - band)
                 + 1).sum())
    return roof(4 * c * b * h * pairs, 4 * b * h * t * c * 2 + b * h * t * 4,
                b * h * pairs)


# The LSTM's bound is a throughput bound: the 200 steps depend on each
# other, so a latency floor of 200 x (one step's product, cell update and
# barrier) sits under it that no roofline term states
LSTM_BOUND_NOTE = ("throughput bound only; the 200 steps are dependent, a "
                   "latency floor of 200 x (product + cell update + "
                   "barrier) lies under it")


# The backward's bound counts one exponential per pair, as the forward's;
# its two deterministic kernels recompute p once each
BWD_BOUND_NOTE = ("one exp per (query, key) pair; the two kernels "
                  "recompute p once each, so their exp floor is 2x this")


def lstm_bound(n, hd):
    """One recurrence launch in bf16: the 2 * 4H * H FLOP of W_hh h per
    sequence, direction and step; 5 special-function operations (3
    sigmoids, 2 tanh) per unit, sequence, direction and step; xp
    [T, 8H, N] in, out [T, 2H, N] out, W_hh and the bias in."""
    flops = 2 * 2 * 4 * hd * hd * n * LSTM_STEPS
    nbytes = 2 * LSTM_STEPS * n * 10 * hd + 2 * 2 * 4 * hd * hd + 4 * 8 * hd
    return roof(flops, nbytes, 5 * 2 * hd * n * LSTM_STEPS)


def ftb_bound(shape):
    """The fused tail in bf16: 2 * 2C * C' FLOP per (b, f, t); x and y
    [B, C, F, T] and h [B, C, T] in, out [B, C', F, T] out (C' = C)."""
    b, c, f, t = shape
    return roof(2 * 2 * c * c * b * f * t,
                2 * (3 * b * c * f * t + b * c * t + 2 * c * c) + 4 * c)


def sdpa_call(q, k, v, w, band=0):
    """scaled_dot_product_attention on the same inputs: [B, H, T, C'] and
    a float bias -w_s |t - s| with -inf on the diagonal (the kernel has
    -100 there) and, with a band, where |t - s| > band, that requires
    grad. Returns (fn, inputs, dw of a bias gradient)."""
    import torch.nn.functional as F

    t = q.shape[1]
    idx = torch.arange(t, device=q.device, dtype=torch.float32)
    dist = (idx[None, :] - idx[:, None]).abs()                   # [s, t]
    bias = (-w.permute(0, 2, 1).float()[..., None] * dist).to(q.dtype)
    bias.masked_fill_(torch.eye(t, dtype=torch.bool, device=q.device),
                      float("-inf"))                              # [B,H,s,t]
    if band > 0:
        bias.masked_fill_(dist > band, float("-inf"))
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
                        ("serve_enc2", ENC2), ("serve_enc3", ENC3),
                        ("train_dec3", TRAIN_DEC3), ("serve_dec3", DEC3)):
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


def ab_times(calls):
    """{name: mean ms} of ``calls`` {name: (function, arguments, repeats)},
    timed in the order given and back (plain, kernel, ..., kernel, plain)."""
    ms = {key: [] for key in calls}
    for key in list(calls) + list(calls)[::-1]:
        f, a, n = calls[key]
        with torch.no_grad():
            ms[key].append(time_ms(f, a, n))
    return {key: statistics.mean(v) for key, v in ms.items()}


def optin_numbers(attention, lstm, ftb, smi):
    """Per call at the opt-in serving path's shapes (the banded forward
    also at the width-48 decoder's of phase 12 (a)), in bf16: the kernel,
    its plain version, the library yardstick and the bound. Returns
    {kernel: {shape name: row}}, a row holding ms, plain_ms, library_ms,
    bound_ms and bound_by."""
    out = {"banded": {}, "lstm": {}, "ftb": {}}
    for name, shape in (("serve_enc2", ENC2), ("serve_enc3", ENC3),
                        ("serve_dec3", DEC3)):
        q, k, v, w = attn_inputs(shape, torch.bfloat16, seed=210)
        b, t, h, c = shape
        fold = [attention._fold(x, b, t, h, c) for x in (q, k, v)]
        wf = attention._fold_w(w, b, t, h)
        fn, ins, _ = sdpa_call(q, k, v, w, band=BAND)
        row = ab_times({
            "plain_ms": (attention.banded_reference_attention,
                         (q, k, v, w, BAND), 2),
            "ms": (lambda: attention._kernel_fwd(*fold, wf, False, BAND),
                   (), 10),
            "library_ms": (fn, ins, 5)})
        row["bound_ms"], row["bound_by"] = banded_bound(shape, BAND)
        out["banded"][name] = row
        del fn, ins
        torch.cuda.empty_cache()
    for name, (n, hd) in (("enc2", LSTM_ENC2), ("enc3", LSTM_ENC3)):
        xp, w, bias = lstm_inputs(n, hd, torch.bfloat16, seed=220)
        cudnn = torch.nn.LSTM(hd, hd, bidirectional=True, batch_first=True)
        cudnn = cudnn.to("cuda", torch.bfloat16)
        cudnn.flatten_parameters()
        seq = torch.randn(n, LSTM_STEPS, hd, device="cuda",
                          dtype=torch.bfloat16)
        # the port's whole layer on cuDNN's input, as models/modules.py
        # BLSTM._recurrence runs it: the input projection of both
        # directions on the [T, C, N] view of [N, T, C], then the
        # recurrence. The weight is a copy that requires no grad, as the
        # model's bf16 copy is: one that does keeps torch.matmul from
        # folding the product into one GEMM (200 batched ones instead)
        w_ih = torch.cat([cudnn.weight_ih_l0,
                          cudnn.weight_ih_l0_reverse]).detach()

        def layer():
            return lstm.lstm_recurrence(
                torch.matmul(w_ih, seq.permute(1, 2, 0)), w, bias)
        row = ab_times({
            "plain_ms": (lstm.reference_lstm_recurrence, (xp, w, bias), 2),
            "ms": (lstm.lstm_recurrence, (xp, w, bias), 10),
            "layer_ms": (layer, (), 10),
            "library_ms": (cudnn, (seq,), 5)})
        row["bound_ms"], row["bound_by"] = lstm_bound(n, hd)
        out["lstm"][name] = row
    for i, shape in enumerate(FTB_SHAPES):
        x, hh, ka, kb, w_freq, b2 = ftb_inputs(shape, torch.bfloat16, 230)
        y = ftb.freq_mix(x, w_freq)
        # the wrapper's call, and the kernel alone on h already transposed
        # and the weights already packed
        ht, w = hh.transpose(1, 2).contiguous(), ftb.pack_ftb_mma(ka, kb)
        row = ab_times({
            "plain_ms": (ftb.reference_fused_tail, (x, y, hh, ka, kb, b2), 2),
            "ms": (ftb._launch, (x, y, hh, ka, kb, b2), 10),
            "kernel_ms": (ftb._launch_mma, (x, y, ht, w, b2), 10)})
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = ftb_bound(shape)
        out["ftb"][f"enc{i}"] = row
        del x, y
        torch.cuda.empty_cache()
    for kernel, rows in out.items():
        for name, r in rows.items():
            lib = ("-" if r["library_ms"] is None
                   else f"{r['library_ms']:.3f}")
            layer = (f" (projection + kernel {r['layer_ms']:.3f}, like "
                     "the library's layer)" if "layer_ms" in r else "")
            if "kernel_ms" in r:
                layer = (f" (the kernel alone on transposed h and packed "
                         f"weights {r['kernel_ms']:.3f})")
            log(f"{kernel} {name} bf16, ms per call: kernel {r['ms']:.3f}, "
                f"plain {r['plain_ms']:.3f}, library {lib}{layer}, bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}) [{smi}]")
    return out


def optin_entry(name, src, replaces, launches, err, rows, per_forward):
    """A kernels-JSON entry of the opt-in serving path: the times summed
    over one canonical forward's calls (``per_forward`` {shape name:
    calls}; ``rows`` may hold more shapes, phase 12's)."""
    def total(key):
        vals = [rows[n][key] for n in per_forward]
        if None in vals:
            return None
        return sum(per_forward[n] * rows[n][key] for n in per_forward)
    top = max((rows[n] for n in per_forward), key=lambda r: r["bound_ms"])
    entry = {"name": name, "route": "cuda",
             "source": f"aero_tpu_torch/csrc/{src}", "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": total("ms"),
             "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
             "bound_by": top["bound_by"], "library_ms": total("library_ms"),
             "per_call": rows, "calls_per_forward": per_forward}
    for key in ("layer_ms", "kernel_ms"):
        if key in top:
            entry[key] = total(key)
    return entry


# --- phase 14: the repro pipeline, the band probe, the variants and the
# precision A/B, through the port's tools ---------------------------------

PHASE14_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "phase14")
PROBE_SECONDS, PROBE_WIDTHS = 10.0, (32, 64, 128, 256, 512)  # its defaults
# the probe's four sites, [B*F, T, H, C'] at 10 s: enc2's two, enc3's two
PROBE_SHAPES = [(8, 2501, 4, 12)] * 2 + [(4, 2501, 4, 24)] * 2
# the float32 kernels' row-wise banded-vs-exact difference against the
# probe's dense float32 out_rel_max, absolute
PROBE_REL_TOL = 1e-4
# the four tool runs of (c): (label, precision, accum_steps) in run order
TOOL_RUNS = (("variant_8-24", "bfloat16", 1),
             ("variant_11-44_hifi", "bfloat16", 4),
             ("ab_precision_float32", "float32", 1),
             ("ab_precision_bfloat16", "bfloat16", 1))


def step_want(precision, accum):
    """The attention launches of one train step: 4 forward and 8 backward
    kernels per microbatch, on the tensor cores in bfloat16."""
    mma = int(precision == "bfloat16")
    return {"forward": 4 * accum, "forward_mma": 4 * accum * mma,
            "backward": 8 * accum, "backward_mma": 8 * accum * mma}


def returned(values):
    """``make`` for ``wrapped``: each call appends its return value."""
    def make(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            values.append(out)
            return out
        return call
    return make


@contextlib.contextmanager
def train_recorders(attention, st, run):
    """Within ``st``: each train step's (seconds, launches) in
    ``run["steps"]``, each epoch's in ``run["epochs"]`` and each ViSQOL
    score in ``run["visqol"]`` (0 where the scorer failed on a file);
    around the block the attention counts set to 0 and the peak memory
    reset before, and read after."""
    from aero_tpu_torch.eval import metrics as eval_metrics
    from aero_tpu_torch.train.solver import Solver
    from aero_tpu_torch.train.train_step import TrainStep

    for key in ("steps", "epochs", "visqol"):
        run[key] = []
    st.enter_context(wrapped(TrainStep, "__call__", recorder(
        attention, run["steps"], sync=True)))
    st.enter_context(wrapped(Solver, "_run_one_epoch", recorder(
        attention, run["epochs"], sync=True)))
    st.enter_context(wrapped(eval_metrics, "get_visqol",
                             returned(run["visqol"])))
    zero_attention_counts(attention)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    run["seconds"] = time.perf_counter() - t0
    run["launches"] = attention_counts(attention)
    run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30


def check_run(run, label, precision, accum, smi):
    """Log the numbers of ``run``; raise unless every step launched
    ``step_want`` and its history holds one epoch, all finite."""
    want = step_want(precision, accum)
    bad = [c[1] for c in run["steps"] if c[1] != want]
    step_ms = [c[0] * 1e3 for c in run["steps"]]
    scores = run["visqol"]
    failed = sum(s == 0.0 for s in scores)
    scored = [s for s in scores if s != 0.0]
    hist = run["history"][-1] if run["history"] else {}
    log(f"{label}: {len(step_ms)} steps of {accum} microbatch(es), "
        f"median step {statistics.median(step_ms or [math.nan]):.1f} ms "
        f"(first {step_ms[0] if step_ms else math.nan:.0f}), epoch "
        f"{', '.join(f'{e[0]:.2f}' for e in run['epochs'])} s, whole run "
        f"{run['seconds']:.1f} s, peak memory {run['peak_gib']:.2f} GiB; "
        f"attention launches {run['launches']}; ViSQOL "
        + (f"average {statistics.mean(scored):.4f} over {len(scored)} files,"
           if scored else "none scored,")
        + f" scorer failed on {failed} of {len(scores)} files; history: "
        f"LSD {hist.get('Average lsd')}, ViSQOL {hist.get('Average visqol')}"
        f", valid {hist.get('evaluation_loss')} [{smi}]")
    if not run["steps"] or bad:
        raise AssertionError(f"{label}: {len(run['steps'])} steps, launches "
                             f"per step not {want}: {bad[:3]}")
    numbers = [v for v in hist.values() if isinstance(v, (int, float))]
    if len(run["history"]) != 1 or not numbers or not all(
            math.isfinite(v) for v in numbers):
        raise AssertionError(f"{label}: history {run['history']}")


def repro_pipeline(attention, smi, root):
    """Phase 14 (a): the port's repro script's dry run, then the train and
    test commands it printed, run in this process through ``main`` of the
    CLIs with ``epochs=1`` (one epoch, not 125) and ``visqol=false`` (the
    synthesized utterances last 0.25 s, under ViSQOL's patch) appended.
    Returns the run's checkpoint.atpu and its train launches."""
    from aero_tpu_torch import test as test_cli
    from aero_tpu_torch.train import __main__ as train_cli

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "aero_tpu_torch", "tools", "repro_vctk.sh")
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", script, "--dry-run",
                           os.path.join(root, "repro")],
                          env=dict(os.environ, PYTHON=sys.executable),
                          capture_output=True, text=True, timeout=300)
    log(proc.stdout.strip())
    log(f"repro dry run: {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0 or "split OK: 100 train / 8 test speakers" \
            not in proc.stdout or "dry-run PASSED" not in proc.stdout:
        log(proc.stderr[-4000:])
        raise AssertionError(f"repro dry run exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    at = lines.index("[repro] dry-run: would execute:")
    train_cmd, test_cmd = (line.split() for line in lines[at + 1:at + 3])
    for cmd, cli in ((train_cmd, "train"), (test_cmd, "test")):
        if cmd[:3] != [sys.executable, "-m", f"aero_tpu_torch.{cli}"]:
            raise AssertionError(f"repro printed {cmd[:3]} for the {cli} "
                                 "CLI")
    appended = ["epochs=1", "visqol=false"]
    run_root = os.path.join(root, "repro_run")
    os.makedirs(run_root)
    run = {}
    cwd = os.getcwd()
    with contextlib.ExitStack() as st:
        os.chdir(run_root)
        st.callback(os.chdir, cwd)
        with train_recorders(attention, st, run):
            run["history"] = train_cli.main(train_cmd[3:] + appended)
        t0 = time.perf_counter()
        results = test_cli.main(test_cmd[3:] + appended)
        t_test = time.perf_counter() - t0
    ckpts = glob.glob(os.path.join(run_root, "outputs", "*", "*",
                                   "checkpoint.atpu"))
    check_run(run, "repro_canonical_1ep (train CLI)", "bfloat16", 1, smi)
    log(f"repro_canonical_1ep: test CLI {t_test:.2f} s on "
        f"{results['n_files']} files, LSD {results['lsd']}; {ckpts}")
    if not math.isfinite(results["lsd"]) or len(ckpts) != 1:
        raise AssertionError(f"repro test CLI {results}, checkpoints "
                             f"{ckpts}")
    return ckpts[0], run["launches"]


def row_rel(got, want) -> float:
    """max over rows (b, s, h) of ||got - want|| / max(||want||, 1e-12),
    in float64: the probe's out_rel."""
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-12)).max())


def probe_check(attention, smi, checkpoint):
    """Phase 14 (b): the band probe at its defaults on ``checkpoint``
    (float32 forward on the card, its table printed), then at each site
    and W the float32 kernels, exact and banded, on the captured inputs:
    each against its plain version (F32_ATOL), and their row-wise
    difference against the probe's dense out_rel_max (PROBE_REL_TOL); the
    same in bfloat16 on the tensor cores, printed. Returns the probe
    forward's launches."""
    from aero_tpu_torch.tools import attn_band_probe

    zero_attention_counts(attention)
    t0 = time.perf_counter()
    sites, per_site, _ = attn_band_probe.probe(
        checkpoint, PROBE_SECONDS, PROBE_WIDTHS, torch.device("cuda"))
    launches = attention_counts(attention)
    log(f"band probe: {time.perf_counter() - t0:.1f} s, forward launches "
        f"{launches} [{smi}]")
    shapes = [tuple(s[0].shape) for _, s in sites]
    if shapes != PROBE_SHAPES or launches != {
            "forward": len(PROBE_SHAPES), "forward_mma": 0, "backward": 0,
            "backward_mma": 0}:
        raise AssertionError(f"probe sites {shapes}, launches {launches}")
    fn, plain = attention.local_attention, plain_attention(attention)
    worst = 0.0
    for name, (q, k, v, w) in sites:
        rows = {r[0]: r for r in per_site[name]}
        low = [x.to(torch.bfloat16) for x in (q, k, v)]
        exact, exact_bf16 = fn(q, k, v, w), fn(*low, w)
        mma = fn.mma_launches
        for band in (0,) + PROBE_WIDTHS:
            got = fn(q, k, v, w, band=band)
            err = (got - plain(q, k, v, w, band=band)).abs().max().item()
            if fn.mma_launches != mma or not err <= F32_ATOL:
                raise AssertionError(f"{name} band {band}: float32 kernel "
                                     f"vs plain {err} (atol {F32_ATOL}), "
                                     "or not on the SIMT kernel")
            if band == 0:
                continue
            rel, dense = row_rel(got, exact), float(rows[band][3])
            rel_bf16 = row_rel(fn(*low, w, band=band), exact_bf16)
            if fn.mma_launches != mma + 1:
                raise AssertionError(f"{name} band {band}: bfloat16 not on "
                                     "the tensor cores")
            mma = fn.mma_launches
            gap = abs(rel - dense)
            worst = max(worst, gap)
            log(f"  {name} W {band:3d}: banded vs exact, f32 kernels "
                f"{rel:.4e}, probe {dense:.4e} (|gap| {gap:.2e}); bf16 "
                f"kernels {rel_bf16:.4e}; f32 kernel vs plain {err:.2e}")
            if not gap <= PROBE_REL_TOL:
                raise AssertionError(f"{name} W {band}: kernels' banded vs "
                                     f"exact {rel} against the probe's "
                                     f"{dense} (tol {PROBE_REL_TOL})")
    log(f"band probe: kernels against the probe's out_rel_max, worst |gap| "
        f"{worst:.3e} (tol {PROBE_REL_TOL:g})")
    return launches


def tool_runs(attention, smi, root):
    """Phase 14 (c): ``python -m aero_tpu_torch.tools.train_variants
    which=8-24,11-44 epochs=1`` and ``python -m
    aero_tpu_torch.tools.ab_precision epochs=1 n_files=16``, their
    ``main`` in this process, each train subprocess they start run as
    ``main`` of the train CLI in its run directory instead (so that the
    launches are counted). Returns the four runs."""
    from aero_tpu_torch.tools import _runs, ab_precision, train_variants
    from aero_tpu_torch.train import __main__ as train_cli

    runs = []

    def make(original):
        def run_train(cmd, run_dir, capture=False):
            if list(cmd[:3]) != _runs.TRAIN:
                raise AssertionError(f"a tool ran {cmd[:3]}")
            run = {"cmd": list(cmd)}
            cwd = os.getcwd()
            with contextlib.ExitStack() as st:
                os.chdir(run_dir)
                st.callback(os.chdir, cwd)
                with train_recorders(attention, st, run):
                    run["history"] = train_cli.main(list(cmd[3:]))
            runs.append(run)
            return subprocess.CompletedProcess(list(cmd), 0, "", "")
        return run_train

    with wrapped(_runs, "run_train", make):
        rc_variants = train_variants.main([
            "which=8-24,11-44", "epochs=1", f"out={root}/variants"])
        rc_ab = ab_precision.main([
            "epochs=1", "n_files=16", f"out={root}/ab_precision"])
    if rc_variants or rc_ab or len(runs) != len(TOOL_RUNS):
        raise AssertionError(f"train_variants exited {rc_variants}, "
                             f"ab_precision {rc_ab}, {len(runs)} runs")
    for run, (label, precision, accum) in zip(runs, TOOL_RUNS):
        if f"precision={precision}" not in run["cmd"] or (
                f"accum_steps={accum}" in run["cmd"]) != (accum > 1):
            raise AssertionError(f"{label}: {run['cmd']}")
        check_run(run, label, precision, accum, smi)
    return runs


def repro_and_tools(attention, smi):
    """Phase 14: (a) ``repro_pipeline``, (b) ``probe_check`` on its
    checkpoint, (c) ``tool_runs``, in ``build/phase14`` (removed after).
    Returns the train launches of (a) and (c) and the probe's."""
    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    os.makedirs(PHASE14_DIR)
    with phase("14 (a) repro pipeline"):
        checkpoint, repro = repro_pipeline(attention, smi, PHASE14_DIR)
    with phase("14 (b) band probe"):
        probe = probe_check(attention, smi, checkpoint)
    with phase("14 (c) variants and precision A/B"):
        runs = tool_runs(attention, smi, PHASE14_DIR)
    shutil.rmtree(PHASE14_DIR)
    launches = {"repro_canonical_1ep": repro}
    for run, (label, _, _) in zip(runs, TOOL_RUNS):
        launches[label] = run["launches"]
    return launches, probe


# the forwards (rows, padded input samples) of the benchmark's speech files
# cell: one row of 1-10 s, then two and three full 10 s chunks; then more
# full chunks, up to the bulk cells' 16, for the rule's cut-off
FILES_SHAPES = [(1, n) for n in range(LR_SR, SECONDS * LR_SR + 1, LR_SR)] + [
    (2, SECONDS * LR_SR), (3, SECONDS * LR_SR)]
RULE_SHAPES = [(r, SECONDS * LR_SR) for r in (4, 6, 8, 12, BATCH)]
# every call against a warm eager forward, relative L2 of the outputs, both
# under cuDNN's deterministic algorithms (its benchmark off), where two eager
# forwards agree to the bit
GRAPH_GAP = 1e-6
GRAPH_REPEATS = 10
# the graphs of the files cell's 12 shapes against the pool's first
# capture (its floor, one row of GRAPH_MAX_SAMPLES, and 1 x 4000): bytes
# the pool may hold (1.35 x on an H100: captured smallest first without
# the floor, the 12 graphs held 2.0 x the floor's memory)
POOL_GROWTH = 1.5


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, its benchmark off; restored
    after."""
    cudnn = torch.backends.cudnn
    old = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = old


def device_kernels(fn):
    """The names of the device operations of one call of ``fn``, counted
    (torch.profiler: CUPTI lists a CUDA graph's kernel nodes one by
    one)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return Counter(e.name for e in prof.events() if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False))


def cuda_graphs(smi):
    """Phase 15: ``EvalForward``'s CUDA graphs with the canonical bf16
    generator at the files cell's 12 shapes and at 4 to 16 full chunks
    (music's 16 x 110250 by the rule alone). Under cuDNN's deterministic
    algorithms, per shape: the kinds of three calls (eager, capture, replay
    up to ``GRAPH_MAX_SAMPLES``, the first capture after the pool's
    floor); each call's output against a warm eager forward, within
    GRAPH_GAP; 10 more calls: replays move none of the kernel wrappers'
    counters, eager calls as many as 10 eager forwards; one profiled
    replay against one profiled eager forward: the same 4 attention kernels
    on the device, and the other kernels' counts; the graphs' pool after the
    first capture and after the last. Then, in the default algorithms, per
    shape alone in a fresh pool: host ms of the eager launches
    (``gen.spectra``) and of the eager forward (what ``serve.forward``
    holds: the iSTFT's host read waits for the device), the graph's device
    ms, the replayed forward's host ms and the pool one graph holds.
    Returns the rows."""
    from aero_tpu_torch.eval import forward as fwd_mod
    from aero_tpu_torch.eval.forward import CudaGraphs, EvalForward
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)
    from aero_tpu_torch.utils import profiling

    gen = build_generator(CANONICAL_AERO_4_16, "bfloat16", "cuda", seed=0)
    fwd = EvalForward(gen, scale=HR_SR / LR_SR, lr_sr=LR_SR, device="cuda")
    rng = np.random.default_rng(15)
    attn_kernel = "local_attention_fwd_mma_kernel"
    card_bytes = torch.cuda.get_device_properties(0).total_memory

    def moved(before, after):
        return {k: after[k] - before[k] for k in after
                if after[k] != before[k]}

    def host_ms(fn, n=5):  # median host-to-host ms, the device idle first
        runs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(runs)

    def launch_ms(fn, n=5):  # median host ms of the launches alone
        runs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            runs.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return statistics.median(runs)

    def device_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    def signal(rows, n):
        return torch.from_numpy((0.1 * rng.standard_normal(
            (rows, 1, n))).astype(np.float32)).cuda()

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = graph_pool_bytes()
    rows_out, faults, first_pool = [], [], None
    log(f"cuda graphs, canonical bf16, GRAPH_MAX_SAMPLES "
        f"{fwd_mod.GRAPH_MAX_SAMPLES}, cuDNN deterministic [{smi}]:")
    log(f"  rows x samples | [eager, captured, replayed] of 3 calls | their "
        f"rel L2 to an eager forward, beside {GRAPH_GAP:g} (two eager "
        f"forwards') | the 3 calls' ms | {GRAPH_REPEATS} calls: wrapper "
        f"counters moved, replays | {attn_kernel} on the device, a replay "
        f"and an eager forward | all device operations of the two, and how "
        f"many each has that the other lacks | MiB of the graphs' pool "
        f"after")
    with deterministic_cudnn():
        for rows, n in FILES_SHAPES + RULE_SHAPES:
            x = signal(rows, n)
            graphed = rows * n <= fwd_mod.GRAPH_MAX_SAMPLES
            with torch.inference_mode():
                ref, again = (gen(x).float().cpu().numpy() for _ in range(2))
            spread = rel_l2(again, ref)
            want_calls = ([1, 1, 1] if graphed else [3, 0, 0])
            if graphed and fwd._floor is None:  # and the pool's floor
                want_calls = [2, 2, 1]
            kinds = forward_kinds()
            outs, call_ms = [], []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(fwd._run(x, n).cpu().numpy())
                call_ms.append(1e3 * (time.perf_counter() - t0))
            calls = [a - b for a, b in zip(forward_kinds(), kinds)]
            pool = graph_pool_bytes() - base
            if graphed and first_pool is None:
                first_pool = pool
            gap = max(rel_l2(o, ref) for o in outs)
            before = profiling.counters()
            for _ in range(GRAPH_REPEATS):
                fwd._run(x, n)
            mid = profiling.counters()
            with torch.inference_mode():
                for _ in range(GRAPH_REPEATS):
                    gen(x)
            via_fwd = moved(before, mid)
            replays = via_fwd.get("EvalForward.graph_replays", 0)
            via_fwd = {k: v for k, v in via_fwd.items()
                       if not k.startswith("EvalForward.")}
            eager = moved(mid, profiling.counters())
            kinds = forward_kinds()
            k_call = device_kernels(lambda: fwd._run(x, n))
            profiled = [a - b for a, b in zip(forward_kinds(), kinds)]
            with torch.inference_mode():
                k_eager = device_kernels(lambda: gen(x))
            attn = (sum(c for k, c in k_call.items() if attn_kernel in k),
                    sum(c for k, c in k_eager.items() if attn_kernel in k))
            # names cut short; the profiler may also list a few operations
            # of the work before it, on either side
            extra, missing = ({k[:60]: c for k, c in d.items()}
                              for d in (k_call - k_eager, k_eager - k_call))
            row = {"rows": rows, "samples": n, "calls": calls, "gap": gap,
                   "eager_spread": spread, "call_ms": call_ms,
                   "counters": via_fwd, "replays": replays,
                   "counters_eager": eager, "attention_kernels": attn,
                   "kernels": [sum(k_call.values()), sum(k_eager.values())],
                   "kernels_extra": extra, "kernels_missing": missing,
                   "pool_after": pool}
            rows_out.append(row)
            log(f"  {rows:2d} x {n:6d} | {calls} | {gap:.3e} ({spread:.3e}) "
                f"| {', '.join(f'{t:.1f}' for t in call_ms)} | {via_fwd}, "
                f"{replays} | {attn[0]}, {attn[1]} | {row['kernels']}, "
                f"{sum(extra.values())} and {sum(missing.values())} apart | "
                f"{pool / 2 ** 20:.1f}")
            want_counters = {} if graphed else eager
            want_replays = GRAPH_REPEATS if graphed else 0
            if (calls != want_calls or not gap <= GRAPH_GAP
                    or via_fwd != want_counters or replays != want_replays
                    or profiled != ([0, 0, 1] if graphed else [1, 0, 0])
                    or attn != (4, 4)):
                faults.append(
                    f"{rows} x {n}: calls {calls} (want {want_calls}), gap "
                    f"{gap:.3e}, counters {via_fwd} (want {want_counters}), "
                    f"replays {replays} (want {want_replays}), profiled "
                    f"call {profiled}, attention kernels {attn}")
            del x
        torch.cuda.synchronize()
        held = graph_pool_bytes() - base
    music = fwd._graph_key(torch.empty(BATCH, 1, 110250, device="cuda"),
                           False)
    n_graphs = sum(r["calls"][1] for r in rows_out)
    log(f"cuda graphs: {n_graphs} captures by EvalForward (the floor "
        f"included); their pool {first_pool / 2 ** 20:.1f} MiB after the "
        f"first (the floor and 1 x {LR_SR}), {held / 2 ** 20:.1f} MiB after "
        f"the last ({100 * held / card_bytes:.2f}% of the card; want at "
        f"most {POOL_GROWTH:g} x the first); music bulk 16 x 110250 "
        f"{'graphed' if music else 'eager'} [{smi}]")
    if music is not None:
        faults.append("the music bulk forward would replay")
    if not held <= POOL_GROWTH * first_pool:
        faults.append(f"the pool grew from {first_pool} to {held} bytes")
    del fwd
    torch.cuda.empty_cache()
    # in the default algorithms, every shape captured for the measurement,
    # one graph at a time in a pool of its own
    measure = CudaGraphs("cuda")
    log("  rows x samples | ms: eager launches, eager forward, graph device, "
        "replayed forward (the iSTFT eager after it) | MiB of its pool")
    for row in rows_out:
        rows, n = row["rows"], row["samples"]
        x = signal(rows, n)
        with torch.inference_mode():
            row["launch_ms"] = launch_ms(lambda: gen.spectra(x))
            row["eager_ms"] = host_ms(lambda: gen(x))
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = graph_pool_bytes()
            graph = measure.capture(lambda x: gen.spectra(x)[0], x)
            row["pool_bytes"] = graph_pool_bytes() - before
            row["device_ms"] = device_ms(lambda: graph.replay(x))
            row["replay_ms"] = host_ms(
                lambda: gen.synthesis(graph.replay(x), n))
        del graph, x
        measure.clear()
        torch.cuda.empty_cache()
        log(f"  {rows:2d} x {n:6d} | {row['launch_ms']:7.2f} "
            f"{row['eager_ms']:7.2f} {row['device_ms']:7.2f} "
            f"{row['replay_ms']:7.2f} | {row['pool_bytes'] / 2 ** 20:.1f}")
    log(json.dumps({"cuda_graphs": rows_out, "pool_first": first_pool,
                    "pool_last": held}))
    del gen
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("cuda graphs: " + "; ".join(faults))
    return rows_out


def group_norm_sites(gn, chunk: int):
    """(name, x shape, groups, act, rows of a) of each GroupNorm call in one
    bfloat16 forward of the canonical generator at the lr_sr whose 10 s
    chunk is ``chunk`` samples, at batch 1; checks that the forward
    launched the kernel pair at every site and took no autograd path, and
    that a forward while autograd records does the reverse."""
    from aero_tpu_torch.models import modules as M
    from aero_tpu_torch.models.factory import (
        CANONICAL_AERO_4_16, build_generator)

    lr_sr = chunk // SECONDS
    kw = dict(CANONICAL_AERO_4_16, lr_sr=lr_sr, hr_sr=4 * lr_sr)
    gen = build_generator(kw, "bfloat16", "cuda", seed=0)
    sites = []

    def record(name):
        def hook(m, args):
            x = args[0]
            act = args[1] if len(args) > 1 else "none"
            rows = args[2].shape[0] if len(args) > 2 else 0
            sites.append((name, tuple(x.shape), m.num_groups, act, rows))
        return hook
    hooks = [m.register_forward_pre_hook(record(name))
             for name, m in gen.named_modules()
             if isinstance(m, M.GroupNorm)]
    x = 0.1 * torch.randn(1, 1, chunk, device="cuda")
    counts = (gn.group_norm.calls, gn.group_norm.autograd_calls)
    with torch.inference_mode():
        gen(x)
    for h in hooks:
        h.remove()
    served = (gn.group_norm.calls - counts[0],
              gn.group_norm.autograd_calls - counts[1])
    counts = (gn.group_norm.calls, gn.group_norm.autograd_calls)
    gen(x)  # autograd records (the forward alone: the eval-mode LSTM)
    trained = (gn.group_norm.calls - counts[0],
               gn.group_norm.autograd_calls - counts[1])
    log(f"  group_norm at 1 x {chunk}: {len(sites)} sites; (calls, "
        f"autograd_calls) served {served}, while autograd records {trained}")
    if served != (len(sites), 0) or trained != (0, len(sites)):
        raise AssertionError(f"group_norm: counters {served}, {trained} for "
                             f"{len(sites)} sites")
    del gen
    torch.cuda.empty_cache()
    return sites


def gn_inputs(shape, groups, act, rows, dtype, seed, offset=0):
    """x = 2 + 3 N(0, 1) in ``dtype`` (``offset`` elements past its
    allocation's start), weight 1 + 0.3 N, bias 0.3 N and Snake's a from
    the init's Exponential(mean 10), float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 + 3 * torch.randn(shape, device="cuda", generator=g)).to(dtype)
    if offset:
        x = at_offset(x, offset)
    c = shape[1]
    w = 1 + 0.3 * torch.randn(c, device="cuda", generator=g)
    b = 0.3 * torch.randn(c, device="cuda", generator=g)
    a = (torch.empty(rows, device="cuda").exponential_(0.1, generator=g)
         if act == "snake" else None)
    return x, groups, w, b, 1e-5, act, a


def check_group_norm(gn, args, label):
    """The kernel pair against the plain version on ``args``, then under a
    CUDA graph: two replays must give the eager launch's bits and move no
    counter. Returns the error over max|plain|."""
    got = gn.group_norm(*args)
    want = gn.reference_group_norm(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    dtype = args[0].dtype
    del want
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = gn.group_norm(*args)
    calls = gn.group_norm.calls
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(static.clone())
    torch.cuda.synchronize()
    same = (torch.equal(replays[0], replays[1])
            and torch.equal(replays[0], got))
    log(f"  group_norm {label} {str(dtype)[6:]:8s} {tuple(args[0].shape)} "
        f"G {args[1]} {args[5]}: max abs err {err:.3e} ({err / scale:.1e} of "
        f"max; tol {GN_TOL[dtype]:g}), replays {'same bits' if same else 'DIFFER'}")
    if (got.shape != static.shape or not err <= GN_TOL[dtype] * scale
            or not same or gn.group_norm.calls != calls):
        raise AssertionError(f"group_norm {label} {tuple(args[0].shape)} "
                             f"{args[5]} {dtype}: err {err} > "
                             f"{GN_TOL[dtype]} * {scale}, replays same "
                             f"{same}, calls moved by replays "
                             f"{gn.group_norm.calls - calls}")
    del graph, static, replays, got
    return err / scale


def group_norm_kernels(smi):
    """Phase 16: the GroupNorm kernel pair (``ops.group_norm``) at every
    GroupNorm site of the canonical generator, speech (T 2501) and music
    (T 6892), at batch 1 and 16, bfloat16 (speech at batch 1 in float32
    too), against the plain version, eagerly and as two replays of a CUDA
    graph, which must give the eager bits; then ragged cases: T 777 and
    1001, a GLU half-plane no vector width divides, x 3 (misaligned) and 8
    elements past its allocation. Then per site at speech batch 1 and 16,
    each call's device ms as a CUDA graph replays it: the kernel pair's
    beside its bound (each input byte read twice, each output byte written
    once, at the HBM rate), the plain version's, the library's
    (``F.group_norm`` in x's dtype, then the activation) and the chain the
    port ran before the pair (``F.group_norm`` on a float32 copy, the cast
    back, the activation); and the pair's ms launched eagerly, which at
    batch 1 is its host's. Returns the numbers."""
    import torch.nn.functional as F

    from aero_tpu_torch.ops import group_norm as gn

    f32, bf16 = torch.float32, torch.bfloat16
    sites = {cfg: group_norm_sites(gn, n) for cfg, n in GN_CHUNKS.items()}
    worst = 0.0
    seed = 1600
    for cfg, cfg_sites in sites.items():
        for batch in (1, BATCH):
            for dtype in ((f32, bf16) if (cfg, batch) == ("speech", 1)
                          else (bf16,)):
                for name, shape, groups, act, rows in cfg_sites:
                    shape = (shape[0] * batch,) + shape[1:]
                    seed += 1
                    args = gn_inputs(shape, groups, act, rows, dtype, seed)
                    err = check_group_norm(gn, args, f"{cfg} B{batch} {name}")
                    worst = max(worst, err) if dtype == bf16 else worst
                    del args
                    torch.cuda.empty_cache()
    ragged = [((3, 24, 5, 777), 4, a, 0, 0) for a in ("none", "gelu", "glu")]
    ragged += [((10, 18, 1001), 1, "snake", 5, 0),
               ((10, 18, 1001), 1, "gelu", 0, 0),
               ((2, 6, 777), 2, "glu", 0, 0),        # half-plane 2331
               ((3, 24, 5, 777), 4, "gelu", 0, 3), ((10, 18, 1001), 1,
                                                     "snake", 5, 3),
               ((3, 24, 5, 777), 4, "glu", 0, 3),
               ((3, 24, 5, 777), 4, "gelu", 0, 8)]
    for dtype in (f32, bf16):
        for shape, groups, act, rows, offset in ragged:
            seed += 1
            check_group_norm(gn, gn_inputs(shape, groups, act, rows, dtype,
                                           seed, offset),
                             f"ragged +{offset}")

    def library(x, groups, w, b, eps, act, a):
        return gn.activation(F.group_norm(x, groups, w.to(x.dtype),
                                          b.to(x.dtype), eps), act, a)

    def parent(x, groups, w, b, eps, act, a):
        return gn.activation(F.group_norm(x.float(), groups, w, b,
                                          eps).to(x.dtype), act, a)

    def graph_ms(fn, args, n):  # device ms of a call, its launches captured
        fn(*args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn(*args)
        return time_ms(graph.replay, (), n)

    numbers = {}
    log(f"group_norm per site, bf16, device ms of a call replayed from a "
        f"CUDA graph [{smi}]: kernel pair | bound "
        f"(2 reads + 1 write at {PEAK_HBM_BYTES / 1e12:.2f} TB/s) | plain | "
        f"library (F.group_norm in bf16 + act) | the chain before the pair "
        f"(F.group_norm on f32 + cast + act) | the pair launched eagerly "
        f"(host-bound at batch 1)")
    for batch in (1, BATCH):
        totals = dict.fromkeys(("kernel", "bound", "plain", "library",
                                "parent", "kernel_eager"), 0.0)
        for name, shape, groups, act, rows in sites["speech"]:
            shape = (shape[0] * batch,) + shape[1:]
            args = gn_inputs(shape, groups, act, rows, bf16, 7)
            n = 50 if batch == 1 else 10
            c_out = shape[1] // 2 if act == "glu" else shape[1]
            out_bytes = args[0].numel() // shape[1] * c_out * 2
            row = {"kernel": graph_ms(gn.group_norm, args, n),
                   "bound": 1e3 * (4 * args[0].numel() + out_bytes)
                   / PEAK_HBM_BYTES,
                   "plain": graph_ms(gn.reference_group_norm, args, n),
                   "library": graph_ms(library, args, n),
                   "parent": graph_ms(parent, args, n),
                   "kernel_eager": time_ms(gn.group_norm, args, n)}
            for k, v in row.items():
                totals[k] += v
            numbers[f"speech_b{batch}.{name}"] = row
            log(f"  B{batch:2d} {name:36s} {str(shape):22s} {act:5s} "
                + " | ".join(f"{row[k]:.4f}" for k in totals))
            del args
            torch.cuda.empty_cache()
        numbers[f"speech_b{batch}.forward"] = totals
        log(f"  B{batch:2d} the {len(sites['speech'])} sites of a forward: "
            + " | ".join(f"{k} {v:.3f}" for k, v in totals.items()))
    log(json.dumps({"group_norm": numbers, "max_rel_err_bf16": worst}))
    return numbers


def main():
    smi = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aero_tpu_torch.ops import _build, attention, ftb, lstm

    log(f"exp rate: {exp_rate():.4g} /s ({SFU_PER_SM_CLOCK} per SM and "
        "clock at the max SM clock)")
    with phase("2 build"):
        _build.library()
        log(f"library: {_build.library_path()}")
        if not _build.build_log:
            log("ptxas: the library was built by an earlier process; no "
                "registers or spills to report")
        spilling = print_ptxas(_build.build_log)
        log("ptxas: instances that spill: "
            + (", ".join(spilling) if spilling else "none"))
        bad = [n for n in spilling if "_mma_kernel<" in n and "bwd" in n
               and n.endswith((", 12>", ", 24>"))]
        if bad:
            raise AssertionError(f"tensor-core backward spills at a path "
                                 f"width: {bad}")

    f32, bf16 = torch.float32, torch.bfloat16
    with phase("3 attention forward"):
        path_shapes = (ENC2, ENC3, TRAIN_ENC2, TRAIN_ENC3, DEC2, DEC3,
                       TRAIN_DEC3, TIME_ENC3)
        fwd_err = check_kernel(attention, [
            ((2, t, 2, c), dt, 0) for dt in (f32, bf16) for c in (12, 24)
            for t in (500, 2501, 3000, 4097, 6891)] + [
            ((2, t, 2, 48), dt, 0) for dt in (f32, bf16)
            for t in (500, 2501, 4097)] + [
            ((2, 777, 2, c), bf16, 0) for c in attention.KERNEL_WIDTHS] + [
            (s, bf16, 0) for s in path_shapes], path_shapes)
        band_err = check_kernel(attention, [
            ((2, t, 2, c), dt, w) for dt in (f32, bf16) for c in (12, 24)
            for t in (501, 2501, 4097) for w in (16, BAND, t - 1)] + [
            ((2, t, 2, 48), dt, w) for dt in (f32, bf16)
            for t in (500, 2501, 4097) for w in (16, BAND)] + [
            ((2, 777, 2, c), bf16, w) for c in attention.KERNEL_WIDTHS
            for w in (16, 776)] + [
            (ENC2, bf16, BAND), (ENC3, bf16, BAND), (DEC3, bf16, BAND)],
            (ENC2, ENC3, DEC3))
    with phase("4 attention backward"):
        bwd_abs, bwd_rel = check_backward(attention, [
            ((2, t, 2, c), dt, 0) for dt in (f32, bf16) for c in (12, 24)
            for t in (501, 762, 1379, 2048, 2501, 4097)] + [
            ((2, t, 2, 48), dt, 0) for dt in (f32, bf16)
            for t in (501, 2501)] + [
            (TRAIN_ENC2, bf16, 0), (TRAIN_ENC3, bf16, 0),
            (TRAIN_DEC3, bf16, 0)])
        check_backward(attention, [
            ((2, t, 2, c), dt, w) for dt in (f32, bf16) for c in (12, 24, 48)
            for t in (501, 2501) for w in (16, BAND)] + [
            (TRAIN_ENC2, bf16, BAND), (TRAIN_ENC3, bf16, BAND)])
    with phase("5 lstm and ftb kernels"):
        lstm_err = check_lstm(lstm)
        ftb_err = check_ftb(ftb)
    with phase("6 serving"):
        serve_launches, optin_launches = serving(attention, lstm, ftb)
    with phase("7 training"):
        train_gaps(attention)
        train_launches, train_ms = training(attention, smi)
    with phase("8 numbers"):
        nums = attention_numbers(attention, smi)
        opt = optin_numbers(attention, lstm, ftb, smi)
    with phase("9 solver"):
        solver_launches = solver(attention, smi)
    with phase("10 hifi and seanet"):
        hifi_launches = hifi_seanet(attention, lstm, ftb, smi)
    with phase("11 ddp"):
        ddp_launches = data_parallel(smi, train_ms)
    with phase("12 generator options"):
        options = generator_options(attention, lstm, ftb, smi)
    with phase("14 repro, band probe, variants"):
        tool_launches, probe_launches = repro_and_tools(attention, smi)
    with phase("15 cuda graphs"):
        cuda_graphs(smi)
    with phase("16 group norm"):
        group_norm_kernels(smi)

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
        entry("local_attention_fwd", "fwd", "local_attention_mma.cu", 298,
              train_launches["forward_mma"], fwd_err, None),
        entry("local_attention_bwd", "bwd", "local_attention_bwd_mma.cu",
              422, train_launches["backward_mma"], bwd_abs, bwd_rel)]
    kernels[1]["bound_note"] = BWD_BOUND_NOTE
    kernels[0]["launches_serving_forward"] = serve_launches["attention_mma"]
    kernels[0]["launches_solver"] = solver_launches["forward_mma"]
    kernels[1]["launches_solver"] = solver_launches["backward_mma"]
    kernels[0]["launches_hifi_step"] = hifi_launches["forward_mma"]
    kernels[1]["launches_hifi_step"] = hifi_launches["backward_mma"]
    for i, key in enumerate(("forward_mma", "backward_mma")):
        kernels[i]["launches_ddp_nccl_step"] = ddp_launches["nccl"][key]
    # the float32 ranks run the SIMT kernels (local_attention.cu,
    # local_attention_bwd.cu): their launches of the accum-1 step per rank
    for i, key in enumerate(("forward", "backward")):
        kernels[i]["launches_ddp_f32_rank_steps"] = [
            c[key] for c in ddp_launches["gloo"]]
    # phase 12: dconv_mode 3 serving (8) and its train step (8 + 16), the
    # time-axis serving cell (4); the per-call times at width 48 are in
    # per_call under serve_dec3 and train_dec3
    kernels[0]["launches_options_serving_dconv3"] = \
        options["serve_dconv3"]["attention_mma"]
    kernels[0]["launches_options_serving_time_gelu"] = \
        options["serve_time_gelu"]["attention_mma"]
    for i, key in enumerate(("forward_mma", "backward_mma")):
        kernels[i]["launches_options_train_dconv3_step"] = \
            options["train_dconv3"][key]
    # phase 14: the train launches of the repro run (a) and of the four
    # tool runs (c), whole runs (the float32 A/B arm on the SIMT kernels);
    # the band probe's float32 forward (b): 4 on the SIMT kernel
    for i, key in enumerate(("forward", "backward")):
        kernels[i]["launches_phase14"] = {
            label: counts[key] for label, counts in tool_launches.items()}
    kernels[0]["launches_band_probe_forward_f32"] = probe_launches["forward"]
    kernels += [
        optin_entry("local_attention_banded_fwd", "local_attention_mma.cu",
                    "aero_tpu/ops/attention.py:180", optin_launches["banded"],
                    band_err, opt["banded"],
                    {"serve_enc2": 2, "serve_enc3": 2}),
        optin_entry("lstm_recurrence", "lstm_mma.cu",
                    "aero_tpu/ops/lstm.py:54", optin_launches["lstm_mma"],
                    lstm_err, opt["lstm"], {"enc2": 4, "enc3": 4}),
        optin_entry("ftb_tail", "ftb_mma.cu", "aero_tpu/ops/ftb.py:48",
                    optin_launches["ftb_mma"], ftb_err, opt["ftb"],
                    {f"enc{i}": 1 for i in range(4)})]
    kernels[3]["bound_note"] = LSTM_BOUND_NOTE
    for i, key in ((2, "banded"), (3, "lstm_mma"), (4, "ftb_mma")):
        kernels[i]["launches_options_optin_dconv3"] = \
            options["optin_dconv3"][key]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
