"""The port's host data pipeline against aero_tpu's on the CPU: the numpy
resampler, the dummy dataset, ``LrHrSet`` items (segmented, whole files
with their paths, spectrograms), ``PrHrSet`` triples and the ``Loader``'s
batches. Inputs come from numpy seeds; everything but the spectrograms
must be bit for bit equal."""

import os

import numpy as np
import pytest
import torch

from aero_tpu.data import datasets as jdata
from aero_tpu.data import loader as jloader
from aero_tpu.data import prep as jprep
from aero_tpu.ops.resample import resample_np as jresample
from aero_tpu_torch.data import datasets as pdata
from aero_tpu_torch.data import loader as ploader
from aero_tpu_torch.data import native_io
from aero_tpu_torch.data import prep as pprep
from aero_tpu_torch.data.resample import resample_np as presample

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes on few cores, and torch's thread pools in
    each would contend for them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# LrHrSet(stft=True): torch.stft against the JAX STFT, both float32, of a
# signal in [-1, 1]: max |got - want| <= STFT_TOL * max |want|
STFT_TOL = 1e-5


def _same(got, want):
    """Equal structure, dtypes, shapes and bytes."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


@pytest.mark.parametrize("rates,shape", [
    ((16000, 4000), (1, 10007)), ((4000, 16000), (2, 3001)),
    ((44100, 16000), (1, 22050)), ((11025, 44100), (3, 1000)),
    ((16000, 48000), (1, 8000))])
def test_resample_np_bit_for_bit(rates, shape):
    x = np.random.default_rng(sum(rates)).uniform(-1, 1, shape).astype(
        np.float32)
    _same(presample(x, *rates), jresample(x, *rates))


@pytest.fixture(scope="module")
def egs(tmp_path_factory):
    """The same dummy dataset written by both packages."""
    root = tmp_path_factory.mktemp("egs")
    pprep.make_dummy_dataset(str(root / "port"), n_files=5, duration=1.3,
                             seed=3)
    jprep.make_dummy_dataset(str(root / "jax"), n_files=5, duration=1.3,
                             seed=3)
    return root


def test_dummy_dataset_matches_jax(egs):
    for kind in ("hr", "lr"):
        for name in sorted(os.listdir(egs / "jax" / "wav" / kind)):
            with open(egs / "port" / "wav" / kind / name, "rb") as f:
                got = f.read()
            with open(egs / "jax" / "wav" / kind / name, "rb") as f:
                assert got == f.read(), (kind, name)


@pytest.mark.parametrize("segment,with_path", [(0.5, False), (0.3, False),
                                               (None, True)])
def test_lrhrset_items_match_jax(egs, segment, with_path):
    kw = dict(stride=segment, segment=segment, with_path=with_path,
              upsample=False)
    path = str(egs / "port" / "tr")
    got = pdata.LrHrSet(path, 4000, 16000, **kw)
    want = jdata.LrHrSet(path, 4000, 16000, **kw)
    assert len(got) == len(want) >= 5
    for i in range(len(want)):
        _same(got[i], want[i])


def test_lrhrset_upsampled_items_match_jax(egs):
    path = str(egs / "port" / "val")
    got = pdata.LrHrSet(path, 4000, 16000, 0.5, 0.5, upsample=True)
    want = jdata.LrHrSet(path, 4000, 16000, 0.5, 0.5, upsample=True)
    for i in (0, len(want) - 1):
        _same(got[i], want[i])


@pytest.mark.parametrize("complex_as_channels", [True, False])
def test_lrhrset_stft_matches_jax(egs, complex_as_channels):
    kw = dict(stride=0.5, segment=0.5, upsample=True, stft=True,
              complex_as_channels=complex_as_channels)
    path = str(egs / "port" / "tr")
    got = pdata.LrHrSet(path, 4000, 16000, **kw)
    want = jdata.LrHrSet(path, 4000, 16000, **kw)
    for i in (0, 3):
        for g, w in zip(got[i], want[i]):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g - w).max() <= STFT_TOL * np.abs(w).max()


def test_native_reader_matches_numpy_codec(egs):
    """Where the tracked native library loads, its segment reads equal the
    numpy codec's (the dataset reads through it)."""
    if not native_io.available():
        pytest.skip("native/lib/libaeroio.so does not load in this image")
    path = str(egs / "port" / "wav" / "hr" / "p001.wav")
    got, sr = native_io.load(path, frame_offset=100, num_frames=5000)
    want, sr_want = pdata.audio_io.load(path, frame_offset=100,
                                        num_frames=5000)
    assert sr == sr_want and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_prhrset_matches_jax(egs, tmp_path):
    rng = np.random.default_rng(5)
    names = ["a_1", "a_12", "b"]
    for name in names:
        for kind, sr, n in (("lr", 4000, 900), ("hr", 16000, 3600),
                            ("pr", 16000, 3500)):
            pdata.audio_io.save(str(tmp_path / f"{name}_{kind}.wav"),
                                rng.uniform(-0.5, 0.5, (1, n)), sr)
    for filenames in (None, ["a_1", "b"]):
        got = pdata.PrHrSet(str(tmp_path), filenames)
        want = jdata.PrHrSet(str(tmp_path), filenames)
        assert len(got) == len(want)
        for i in range(len(want)):
            _same(got[i], want[i])


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_jax(egs, rank, world, drop_last):
    """Three shuffled epochs: the same batches, in the same order."""
    path = str(egs / "port" / "tr")
    kw = dict(batch_size=3, shuffle=True, seed=11, drop_last=drop_last,
              rank=rank, world_size=world, num_workers=2)
    got = ploader.Loader(pdata.LrHrSet(path, 4000, 16000, 0.3, 0.3,
                                       upsample=False), **kw)
    want = jloader.Loader(jdata.LrHrSet(path, 4000, 16000, 0.3, 0.3,
                                        upsample=False), **kw)
    for epoch in range(3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        np.testing.assert_array_equal(got._indices(), want._indices())
        assert len(got) == len(want) > 0
        batches = list(got)
        assert len(batches) == len(want)
        for g, w in zip(batches, want):
            _same(g, w)


def test_eval_loader_with_paths_matches_jax(egs):
    path = str(egs / "port" / "val")
    kw = dict(batch_size=1, shuffle=False, num_workers=1, pad_shards=False)
    got = ploader.Loader(pdata.LrHrSet(path, 4000, 16000, with_path=True,
                                       upsample=False), **kw)
    want = jloader.Loader(jdata.LrHrSet(path, 4000, 16000, with_path=True,
                                        upsample=False), **kw)
    for g, w in zip(got, want):
        _same(g, w)
