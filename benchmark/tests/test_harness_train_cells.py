"""The controls and faults of the train cells ``music_train`` and
``speech_train_hifi``, each read by its compared numbers, which must come
out not correct: the float32 reference computed in float8 at every product
in the program's place, half of the batch left out (the mean taken over the
rest), and a step that leaves every weight as it was; in the HiFi cell also
a spectral norm that never stores its u, and one that stores it in the
shared real forward too. On the CPU at a tiny size in float32 (the faults,
and a sound run); on an NVIDIA GPU at each cell's own size (the control,
the faults, and the program on many seeds: the lower readings of the
cells' limits). The GPU cases skip without one.

    python3 -m pytest benchmark/tests/test_harness_train_cells.py -s

prints one JSON line per run on the GPU with the compared numbers.
"""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.tests import cells

CELLS = ("music_train", "speech_train_hifi")
SEED = 2 ** 31 + 11
# the HiFi cell's float8 control and half batch sit within 3 x of its
# program's gradient gap, so it reads them, and the program, on more seeds
N_SEEDS = {"music_train": (6, 6, 24), "speech_train_hifi": (12, 12, 48)}


def _seeds(cell, kind):
    """The seeds of the float8 control, the half batch or the program."""
    start, step, n = {"control": (4300000001, 1, 0),
                      "half": (4400000000, 7919, 1),
                      "program": (4500000000, 7919, 2)}[kind]
    return tuple(start + step * i for i in range(N_SEEDS[cell][n]))

# the checked steps come before the window, so a short one reads the same
WINDOW_S = 0.5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _report(cell, kind, seed, result):
    print("\n" + json.dumps({"cell": cell, "kind": kind, "seed": seed,
                             "correct": result["correct"],
                             "checks": result["checks"]}), flush=True)


def _half_batch(monkeypatch):
    from aero_tpu_torch.train.train_step import TrainStep

    grads = TrainStep.grads
    monkeypatch.setattr(TrainStep, "grads", lambda self, lr, hr: grads(
        self, lr[:len(lr) // 2], hr[:len(hr) // 2]))


def _unchanged_state(monkeypatch):
    from aero_tpu_torch.train.train_step import TrainStep

    monkeypatch.setattr(TrainStep, "apply", lambda self, *a: None)


def _unstored_u(monkeypatch):
    """The spectral norm's u is never stored."""
    from aero_tpu_torch.train.train_step import LossComputer

    losses = LossComputer.discriminator_losses
    monkeypatch.setattr(
        LossComputer, "discriminator_losses",
        lambda self, pr_sg, real, store=False: losses(self, pr_sg, real))


def _u_stored_by_real_forward(monkeypatch):
    """The shared real forward stores its u too, so the generator's fake
    forward reads u1 and the discriminator pass starts from u2."""
    from aero_tpu_torch.train.train_step import LossComputer

    def real_outputs(self, hr):
        return {name: self._discriminate(name, hr, store=True)
                for name in self.forwards}

    monkeypatch.setattr(LossComputer, "real_outputs", real_outputs)


U_FAULTS = {"unstored_u": _unstored_u,
            "u_stored_by_real_forward": _u_stored_by_real_forward}


# --- the CPU, at a tiny size -------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = cells.measure(cells.files(cell, tiny=True), SEED, WINDOW_S)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_unchanged_state_is_not_correct(cell, monkeypatch):
    _unchanged_state(monkeypatch)
    result = cells.measure(cells.files(cell, tiny=True), SEED, WINDOW_S)
    assert not result["correct"], result["checks"]
    # 1 for every leaf at or above the median leaf's change, ||Δθ_ref|| /
    # the median's below it: the median of the two middle leaves may fall
    # just under 1
    assert result["checks"]["change_gap"]["value"] > 0.99


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_step_is_not_correct(cell, monkeypatch):
    _half_batch(monkeypatch)
    result = cells.measure(cells.files(cell, tiny=True), SEED, WINDOW_S)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", sorted(U_FAULTS))
def test_u_fault_is_not_correct(fault, monkeypatch):
    U_FAULTS[fault](monkeypatch)
    result = cells.measure(cells.files("speech_train_hifi", tiny=True), SEED,
                           WINDOW_S)
    u_gap = result["checks"]["u_gap"]
    assert u_gap["value"] > u_gap["limit"], result["checks"]


# --- the GPU, at each cell's own size ----------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_card_control_is_not_correct(cell):
    _card()
    files = cells.files(cell)
    correct = []
    for seed in _seeds(cell, "control"):
        result = cells.measure(files, seed, WINDOW_S, device="cuda",
                               make_program=cells.fp8_program)
        _report(cell, "control_fp8", seed, result)
        correct.append(result["correct"])
    assert not any(correct)


@pytest.mark.parametrize("cell", CELLS)
def test_card_half_batch_is_not_correct(cell, monkeypatch):
    _card()
    _half_batch(monkeypatch)
    files = cells.files(cell)
    correct = []
    for seed in _seeds(cell, "half"):
        result = cells.measure(files, seed, WINDOW_S, device="cuda")
        _report(cell, "half_batch", seed, result)
        correct.append(result["correct"])
    assert not any(correct)


@pytest.mark.parametrize("cell", CELLS)
def test_card_unchanged_state_is_not_correct(cell, monkeypatch):
    _card()
    _unchanged_state(monkeypatch)
    seed = _seeds(cell, "control")[0]
    result = cells.measure(cells.files(cell), seed, WINDOW_S, device="cuda")
    _report(cell, "state_unchanged", seed, result)
    assert not result["correct"]


@pytest.mark.parametrize("fault", sorted(U_FAULTS))
def test_card_u_fault_is_not_correct(fault, monkeypatch):
    _card()
    U_FAULTS[fault](monkeypatch)
    files = cells.files("speech_train_hifi")
    ok = []
    for seed in _seeds("speech_train_hifi", "control")[:3]:
        result = cells.measure(files, seed, WINDOW_S, device="cuda")
        _report("speech_train_hifi", fault, seed, result)
        u_gap = result["checks"]["u_gap"]
        ok.append(u_gap["value"] <= u_gap["limit"])
    assert not any(ok)


@pytest.mark.parametrize("cell", CELLS)
def test_card_program_is_correct_on_every_seed(cell):
    _card()
    files = cells.files(cell)
    correct = []
    for seed in _seeds(cell, "program"):
        result = cells.measure(files, seed, WINDOW_S, device="cuda")
        _report(cell, "program", seed, result)
        correct.append(result["correct"])
    assert all(correct)


# --- the readers of the HiFi cell's spans ------------------------------------

HIFI_READERS = ("mpd_ms.train", "msd_ms.train", "mel_ms.train",
                "mpd_roofline.train")


def _hifi_trace(program):
    return {"steps": 2, "batch": 16, "program": program,
            "cfg": cells.files("speech_train_hifi")["config"]}


def test_hifi_readers_read_the_spans():
    from benchmark import harness
    from benchmark.roofline_hifi import mpd_bound_s

    trace = _hifi_trace({
        "device_s": {"hifi.mpd": 0.024, "hifi.msd": 0.07, "loss.mel": 4e-4},
        "spans": {"hifi.mpd": {"count": 6, "host_s": 0.1}}})
    read = {name: harness.load_reader(name).read(trace)
            for name in HIFI_READERS}
    assert read["mpd_ms.train"] == pytest.approx(12.0)
    assert read["msd_ms.train"] == pytest.approx(35.0)
    assert read["mel_ms.train"] == pytest.approx(0.2)
    assert read["mpd_roofline.train"] == pytest.approx(
        100 * 6 * mpd_bound_s(trace["cfg"], 16, 32000) / 0.024)


@pytest.mark.parametrize("program", [None, {"device_s": {}, "spans": {}}])
def test_hifi_readers_read_nothing_without_the_spans(program):
    """A trace with no attribution, or a program that opens none of the
    spans (the parent of the change that adds them)."""
    from benchmark import harness

    trace = _hifi_trace(program)
    for name in HIFI_READERS:
        assert harness.load_reader(name).read(trace) is None, name
