"""The plain reference against the program at a narrow width on the CPU,
in float32: the generator, the chunked serving of a file, and the train
step's losses and each leaf's gradient."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import serve as ref_serve
from benchmark.reference.train import ReferenceStep, segment_lengths
from benchmark.tests import cells

CFG = cells.files("speech_train", tiny=True)["config"]


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def test_generator():
    ref = weights.seeded_reference(CFG, 21, "cpu")
    gen = harness.program_models(CFG, ref, "cpu", False)["generator"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, 4321)).astype(np.float32)) * 0.1
    with torch.inference_mode():
        want = ref["generator"].eval()(x)
        got = gen(x)
    assert got.shape == want.shape == (2, 1, 4 * 4321)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("seconds", [0.3, 1.0, 1.05, 2.0, 3.6])
def test_chunked_serving(seconds):
    """Chunks of 1 s, tails reflected to whole seconds (0.05 s of tail
    reflects again and again), as ``ChunkedInference(EvalForward)``."""
    from aero_tpu_torch.eval.forward import ChunkedInference, EvalForward

    ref = weights.seeded_reference(CFG, 22, "cpu")
    gen = harness.program_models(CFG, ref, "cpu", False)["generator"]
    chunked = ChunkedInference(
        EvalForward(gen, scale=4.0, lr_sr=4000, device="cpu", bucket_s=0.5),
        4000, segment_s=1.0, batch_chunks=True)
    t = int(seconds * 4000)
    x = np.random.default_rng(1).standard_normal((1, 1, t)).astype(
        np.float32) * 0.1
    got = chunked(x)
    want = ref_serve.predict(ref["generator"].eval(), x, 4000, 4.0, "cpu",
                             chunk_s=1.0, bucket_s=0.5, rows=1)
    assert got.shape == want.shape == (1, 1, 4 * t)
    assert _rel(got, want) < 1e-5


def test_reflect_to():
    x = np.arange(4, dtype=np.float32)[None]
    assert ref_serve.reflect_to(x, 11).tolist() == \
        [[0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2]]


def test_train_step():
    from aero_tpu_torch.train.train_step import TrainStep

    ref = weights.seeded_reference(CFG, 23, "cpu")
    models = harness.program_models(CFG, ref, "cpu", True)
    step = TrainStep(harness.port_args(CFG), models, "cpu")
    rstep = ReferenceStep(CFG, ref)
    lr_t, hr_t = segment_lengths(CFG)
    rng = np.random.default_rng(2)
    hr = torch.from_numpy(rng.standard_normal((2, 1, hr_t)).astype(
        np.float32)) * 0.1
    lr = hr[..., ::4].contiguous()
    g_gen, g_disc, metrics, _ = step.grads(lr, hr)
    r_gen, r_disc, losses = rstep.grads(lr, hr)
    assert metrics["total"] == pytest.approx(float(losses["total"]), rel=1e-5)
    assert metrics["discriminator_msd_melgan"] == pytest.approx(
        float(losses["discriminator"]), rel=1e-5)
    # leaf by leaf, against the leaf's reference norm or the median leaf's,
    # whichever is larger (a fault in one leaf shows on its own); leaves
    # whose reference gradient is round-off (under 1e-3 of the median
    # leaf's: a conv's bias under a train-mode BatchNorm) are left out, as
    # the train cell leaves them out
    wants = [torch.zeros_like(p) if g is None else g for g, p in zip(
        r_gen + r_disc, rstep.gen_params + rstep.disc_params)]
    names = [n for n, _ in rstep.gen.named_parameters()] + \
        [n for n, _ in rstep.disc.named_parameters()]
    norms = [float(w.norm()) for w in wants]
    median = float(np.median(norms))
    gaps = {n: float((g - w).norm()) / max(norm, median)
            for n, g, w, norm in zip(names, g_gen + g_disc, wants, norms)
            if norm >= 1e-3 * median}
    assert len(wants) == len(g_gen + g_disc) and len(gaps) > len(wants) / 2
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < 1e-4, (worst, gaps[worst])
