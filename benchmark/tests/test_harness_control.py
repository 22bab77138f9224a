"""On an NVIDIA GPU, at each cell's own size: the lower-precision control
(the float32 reference computed in float8 at every product, in the
program's place) and the training faults read by their compared numbers.
Each must come out not correct. Also the witnesses of what sets the train
cell's worst-leaf readings. Skips without a GPU.

    python3 -m pytest benchmark/tests/test_harness_control.py -s

prints one JSON line per run with the compared numbers.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests import cells

SEEDS = (4100000001, 4100000002, 4100000003)
HALF_SEEDS = tuple(4900000000 + 7919 * i for i in range(12))
CELLS = ("speech_serve_bulk", "music_serve_bulk", "speech_train",
         "speech_serve_files")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _report(cell, kind, seed, result):
    print("\n" + json.dumps({"cell": cell, "kind": kind, "seed": seed,
                      "correct": result["correct"],
                      "checks": result["checks"]}), flush=True)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    _card()
    files = cells.files(cell)
    correct = []
    for seed in SEEDS:
        result = cells.measure(files, seed, 2.0, device="cuda",
                               make_program=cells.fp8_program)
        _report(cell, "control_fp8", seed, result)
        correct.append(result["correct"])
    assert not any(correct)


def test_half_batch_step_is_not_correct(monkeypatch):
    """Half of the batch left out, the mean taken over the rest, on a
    dozen seeds."""
    from aero_tpu_torch.train.train_step import TrainStep

    _card()
    grads = TrainStep.grads

    def half(self, lr, hr):
        return grads(self, lr[:len(lr) // 2], hr[:len(hr) // 2])

    monkeypatch.setattr(TrainStep, "grads", half)
    files = cells.files("speech_train")
    correct = []
    for seed in HALF_SEEDS:
        result = cells.measure(files, seed, 1.0, device="cuda")
        _report("speech_train", "half_batch", seed, result)
        correct.append(result["correct"])
    assert not any(correct)


def test_worst_leaf_gap_is_bfloat16_rounding():
    """What sets the train cell's worst-leaf readings: the program in
    float32 (TF32 off) reads the worst leaf's first-gradient gap under a
    hundredth, and the reference rounded to bfloat16 as the program
    rounds, in the program's place, reads it above a tenth, as the
    program in bfloat16 does."""
    from benchmark.reference import models as R

    _card()
    f32 = cells.files("speech_train")
    f32["config"]["precision"] = "float32"
    for seed in SEEDS:
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            _, read = cells.measure_readings(f32, seed, 1.0, device="cuda")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        print("\n" + json.dumps({"kind": "program_float32", "seed": seed,
                                 "readings": read}), flush=True)
        assert read["grad_gap_worst"] < 0.01
        _, read = cells.measure_readings(
            cells.files("speech_train"), seed, 1.0, device="cuda",
            make_program=cells.rounded_program(R.bf16))
        print("\n" + json.dumps({"kind": "reference_bf16", "seed": seed,
                                 "readings": read}), flush=True)
        assert read["grad_gap_worst"] > 0.1


PROGRAM_SEEDS = tuple(4200000000 + 7919 * i for i in range(12))


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_on_a_dozen_seeds(cell):
    """The program's compared numbers over a dozen seeds: the lower
    readings of the cell's limits."""
    _card()
    files = cells.files(cell)
    correct = []
    for seed in PROGRAM_SEEDS:
        result = cells.measure(files, seed, 2.0, device="cuda")
        _report(cell, "program", seed, result)
        correct.append(result["correct"])
    assert all(correct)
