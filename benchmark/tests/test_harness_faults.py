"""Each cell's run, on the CPU at a tiny size in float32, with the timed
path broken underneath: ``correct`` comes out false for each fault the cell
can have, and true without one. The harness's look for a GPU is skipped
(``run.measure`` is driven directly)."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.tests import cells

SEED = 2 ** 31 + 11
SERVING = ("speech_serve_bulk", "speech_serve_files")


@pytest.mark.parametrize("cell", SERVING + ("speech_train",))
def test_sound_run_is_correct(cell):
    result = cells.measure(cells.files(cell, tiny=True), SEED, 1.0)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", SERVING)
def test_altered_answer_is_not_correct(cell, monkeypatch):
    """Every prediction shifted by one hop where it is produced."""
    from aero_tpu_torch.eval.forward import EvalForward

    call = EvalForward.__call__
    monkeypatch.setattr(EvalForward, "__call__", lambda self, lr: np.roll(
        call(self, lr), 64, axis=-1))
    result = cells.measure(cells.files(cell, tiny=True), SEED, 1.0)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell", SERVING)
def test_half_batch_left_out_is_not_correct(cell, monkeypatch):
    """Only the first half of a batch of chunks is run; its outputs stand
    in for the rest."""
    from aero_tpu_torch.eval.forward import ChunkedInference

    batch = ChunkedInference._batch

    def half(self, stack):
        y = batch(self, stack[:max(1, len(stack) // 2)])
        return np.concatenate([y, y, y])[:len(stack)]

    monkeypatch.setattr(ChunkedInference, "_batch", half)
    result = cells.measure(cells.files(cell, tiny=True), SEED, 1.0)
    assert not result["correct"], result["checks"]


def test_unchanged_state_is_not_correct(monkeypatch):
    """A step that computes its gradients and leaves every weight as it
    was."""
    from aero_tpu_torch.train.train_step import TrainStep

    monkeypatch.setattr(TrainStep, "apply", lambda self, *a: None)
    result = cells.measure(cells.files("speech_train", tiny=True), SEED, 1.0)
    assert not result["correct"], result["checks"]
    assert result["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_step_is_not_correct(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from aero_tpu_torch.train.train_step import TrainStep

    grads = TrainStep.grads
    monkeypatch.setattr(TrainStep, "grads", lambda self, lr, hr: grads(
        self, lr[:len(lr) // 2], hr[:len(hr) // 2]))
    result = cells.measure(cells.files("speech_train", tiny=True), SEED, 1.0)
    assert not result["correct"], result["checks"]
