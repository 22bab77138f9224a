"""The frozen FLOP count: PR 10's numbers for the canonical configuration,
and the program's own count (``aero_tpu_torch.utils.flops``) on a narrow
configuration."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import flops, harness, roofline

CANONICAL = harness.load_json(
    harness.ROOT / "benchmark/configs/aero_4-16_512_64.json")


def test_serving_batch_matches_pr10():
    assert flops.serve_flops(CANONICAL, 1, 40000) == 667_390_600_192
    assert flops.serve_flops(CANONICAL, 16, 40000) == 10_678_249_603_072


def test_train_step_matches_pr10():
    assert flops.train_flops(CANONICAL, 1) == 418_543_936_192
    assert flops.train_flops(CANONICAL, 16) == 6_696_702_979_072


def _narrow():
    cfg = copy.deepcopy(CANONICAL)
    cfg["experiment"]["aero"]["channels"] = 8
    cfg["experiment"]["segment"] = 0.5
    return cfg


@pytest.mark.parametrize("samples", [4000, 5000])
def test_serving_equals_the_programs_count(samples):
    from aero_tpu_torch.utils.flops import count_flops
    from benchmark import weights

    cfg = _narrow()
    ref = weights.seeded_reference(cfg, 3, "cpu")
    gen = harness.program_models(cfg, ref, "cpu", False)["generator"]
    x = torch.zeros(2, 1, samples)
    with torch.inference_mode():
        port = count_flops(gen, x).total
    assert flops.serve_flops(cfg, 2, samples) == port


def test_train_step_equals_the_programs_count():
    from aero_tpu_torch.train.train_step import TrainStep
    from aero_tpu_torch.utils.flops import count_flops
    from benchmark import weights
    from benchmark.reference.train import segment_lengths

    cfg = _narrow()
    cfg["precision"] = "float32"
    ref = weights.seeded_reference(cfg, 3, "cpu")
    models = harness.program_models(cfg, ref, "cpu", True)
    step = TrainStep(harness.port_args(cfg), models, "cpu")
    lr_t, hr_t = segment_lengths(cfg)
    lr, hr = torch.randn(2, 1, lr_t) * 0.1, torch.randn(2, 1, hr_t) * 0.1
    assert flops.train_flops(cfg, 2) == count_flops(step, lr, hr).total


def test_attention_bounds():
    """Serving at T 2501: four calls (two at [128, 2501, 4, 12], two at
    [64, 2501, 4, 24]), bound by their FLOPs. Training at T 501: the
    forward (q, k, v, out in bf16, the decay and the log-sum-exp in f32) and
    the backward (q, k, v, out, its gradient, dq, dk, dv in bf16; the
    decay, the log-sum-exp and the decay's gradient in f32) are bound by
    their bytes."""
    calls = roofline.attention_calls(CANONICAL, 16, 40000)
    assert calls == [(128, 2501, 4, 12)] * 2 + [(64, 2501, 4, 24)] * 2
    flop = sum(4 * n * h * t * t * c for n, t, h, c in calls)
    assert roofline.attention_bound_s(CANONICAL, 16, 40000, False) == \
        pytest.approx(flop / roofline.PEAK_FLOPS)
    moved = sum(24 * n * t * h * c + 20 * n * t * h
                for n, t, h, c in roofline.attention_calls(CANONICAL, 16,
                                                           8000))
    assert roofline.attention_bound_s(CANONICAL, 16, 8000, True) == \
        pytest.approx(moved / roofline.PEAK_BYTES)
