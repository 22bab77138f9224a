"""Each traffic mix's seeded inputs and shapes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import audio, harness
from benchmark.drivers import serve, train
from benchmark.tests import cells

TRAFFIC = harness.HERE / "traffic"


def _mix(name):
    return harness.load_json(TRAFFIC / f"{name}.json")


def test_bulk_mixes_send_160_s_recordings():
    for name, sr in (("bulk_speech_160s", 4000), ("bulk_music_160s", 11025)):
        plan = serve.durations(_mix(name), 5, sr, 50)
        assert (plan == 160 * sr).all()
        assert serve.shapes(plan, sr, 10.0, 1.0) == [(16, 10 * sr)]


def test_files_mix_sends_the_same_sizes_for_every_seed():
    mix = _mix("files_speech_lognormal_4s")
    block = mix["durations"]["block"]
    a = serve.durations(mix, 1, 4000, 3 * block)
    b = serve.durations(mix, 2 ** 31 + 9, 4000, 3 * block)
    assert not (a == b).all()
    for k in range(3):
        part = slice(k * block, (k + 1) * block)
        assert sorted(a[part]) == sorted(b[part]) == sorted(a[:block])
    seconds = np.sort(a[:block]) / 4000
    assert seconds[0] == 1.0                       # the 1 s clip
    assert 3.9 < np.median(seconds) < 4.1          # median 4 s
    assert 13 < np.percentile(seconds, 95) < 17    # p95 about 15 s
    assert seconds[-1] < 60


def test_files_mix_shapes():
    """Batches of 1-3 full 10 s chunks and tails padded to 1..10 s: all
    warmed at set-up."""
    mix = _mix("files_speech_lognormal_4s")
    plan = serve.durations(mix, 3, 4000, mix["durations"]["block"])
    shapes = serve.shapes(plan, 4000, 10.0, 1.0)
    assert shapes == sorted({(1, 4000 * k) for k in range(1, 11)}
                            | {(n, 40000) for n in (2, 3)})
    assert serve.forwards(40000, 40000, 4000) == [(1, 40000)]
    assert serve.forwards(40001, 40000, 4000) == [(1, 40000), (1, 4000)]
    assert serve.forwards(3999, 40000, 4000) == [(1, 4000)]
    assert serve.forwards(125000, 40000, 4000) == [(3, 40000), (1, 8000)]


@pytest.mark.parametrize("kind", ["speech", "music"])
def test_signals_are_seeded(kind):
    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return audio.SIGNALS[kind](g, 3.0, 8000, "cpu").numpy()
    a, b, c = make(2 ** 31 + 1), make(2 ** 31 + 1), make(7)
    assert a.shape == (24000,) and a.dtype == np.float32
    assert (a == b).all() and not (a == c).all()
    assert np.isfinite(a).all()
    assert np.sqrt(np.mean(a ** 2)) == pytest.approx(0.1, rel=1e-3)


def test_resampler_keeps_a_tone():
    t = np.arange(16000) / 16000
    x = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    y = audio.resample(x, 16000, 4000)
    assert y.shape == (4000,)
    want = np.sin(2 * np.pi * 440 * np.arange(4000) / 4000)
    assert np.abs(y[100:-100] - want[100:-100]).max() < 1e-2


def test_train_pool_rows_all_differ():
    files = cells.files("speech_train", tiny=True)
    lr, hr = train.pool(files["config"], files["traffic"], 5, "cpu")
    rows = files["traffic"]["batch"] * files["traffic"]["pool_batches"]
    assert lr.shape == (rows, 1, 2000) and hr.shape == (rows, 1, 8000)
    assert len({r.tobytes() for r in hr}) == rows
