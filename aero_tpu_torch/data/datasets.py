"""Datasets: Audioset segment math, LR/HR pairs, PR/HR eval triples (port of
``aero_tpu/data/datasets.py``).

Host numpy throughout; ``LrHrSet(stft=True)`` computes its spectrograms
with ``torch.stft`` on the CPU.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from aero_tpu_torch.data import audio_io, native_io
from aero_tpu_torch.data.resample import resample_np


def _load_audio(path: str, offset: int, num_frames: int):
    """Segment read through the native library where it loads (GIL-free
    decode in loader threads), the numpy codec otherwise."""
    if native_io.available():
        try:
            return native_io.load(path, frame_offset=offset,
                                  num_frames=num_frames)
        except IOError:
            pass
    return audio_io.load(path, frame_offset=offset, num_frames=num_frames)


def match_signal(signal: np.ndarray, ref_len: int) -> np.ndarray:
    """Zero-pad or trim the last axis to ``ref_len``."""
    sig_len = signal.shape[-1]
    if sig_len < ref_len:
        pad = [(0, 0)] * (signal.ndim - 1) + [(0, ref_len - sig_len)]
        signal = np.pad(signal, pad)
    elif sig_len > ref_len:
        signal = signal[..., :ref_len]
    return signal


class Audioset:
    """Lazy file-segment dataset; ``files`` is a list of (path, length)."""

    def __init__(self, files=None, length=None, stride=None, pad=True,
                 with_path=False, sample_rate=None, channels=None):
        self.files = files
        self.num_examples = []
        self.length = length
        self.stride = stride or length
        self.with_path = with_path
        self.sample_rate = sample_rate
        self.channels = channels
        for _file, file_length in self.files:
            if length is None:
                examples = 1
            elif file_length < length:
                examples = 1 if pad else 0
            elif pad:
                examples = int(math.ceil((file_length - self.length)
                                         / self.stride) + 1)
            else:
                examples = (file_length - self.length) // self.stride + 1
            self.num_examples.append(examples)

    def __len__(self):
        return sum(self.num_examples)

    def __getitem__(self, index):
        for (file, _), examples in zip(self.files, self.num_examples):
            if index >= examples:
                index -= examples
                continue
            num_frames, offset = -1, 0
            if self.length is not None:
                offset = self.stride * index
                num_frames = self.length
            out, sr = _load_audio(str(file), offset, num_frames)
            if self.sample_rate is not None and sr != self.sample_rate:
                raise RuntimeError(
                    f"Expected {file} to have sample rate of "
                    f"{self.sample_rate}, but got {sr}")
            if self.channels is not None and out.shape[0] != self.channels:
                raise RuntimeError(
                    f"Expected {file} to have shape of "
                    f"{self.channels}, but got {out.shape[0]}")
            if num_frames != -1 and out.shape[-1] < num_frames:
                out = np.pad(out, ((0, 0), (0, num_frames - out.shape[-1])))
            if self.with_path:
                return out, str(file)
            return out
        raise IndexError(index)


class LrHrSet:
    """Paired low/high-resolution egs-json dataset (``lr.json``/``hr.json``
    of [path, frames], paired by sorted path).

    ``stft=True`` returns complex-as-channels spectrograms [2C, F, T]
    instead of waveforms (window and hop in milliseconds at the hr rate)."""

    def __init__(self, json_dir, lr_sr, hr_sr, stride=None, segment=None,
                 pad=True, with_path=False, upsample=True,
                 stft=False, win_len=64, hop_len=16, n_fft=4096,
                 complex_as_channels=True):
        self.lr_sr = lr_sr
        self.hr_sr = hr_sr
        self.with_path = with_path
        self.upsample = upsample
        self.stft = stft
        if stft:
            self.window_length = int(hr_sr / 1000 * win_len)
            self.hop_length = int(hr_sr / 1000 * hop_len)
            self.n_fft = n_fft
            self.complex_as_channels = complex_as_channels

        with open(os.path.join(json_dir, "lr.json")) as f:
            lr = json.load(f)
        with open(os.path.join(json_dir, "hr.json")) as f:
            hr = json.load(f)

        # The hr window follows from the lr window by the integer rate
        # ratio where there is one, so pairs stay aligned at rates such as
        # 11.025 kHz, where int(seg * lr_sr) * scale != int(seg * hr_sr).
        lr_stride = int(stride * lr_sr) if stride else None
        lr_length = int(segment * lr_sr) if segment else None
        if hr_sr % lr_sr == 0:
            scale = hr_sr // lr_sr
            hr_stride = lr_stride * scale if stride else None
            hr_length = lr_length * scale if segment else None
        else:
            hr_stride = int(stride * hr_sr) if stride else None
            hr_length = int(segment * hr_sr) if segment else None

        lr.sort()
        hr.sort()
        self.lr_set = Audioset(lr, sample_rate=lr_sr, length=lr_length,
                               stride=lr_stride, pad=pad, channels=1,
                               with_path=with_path)
        self.hr_set = Audioset(hr, sample_rate=hr_sr, length=hr_length,
                               stride=hr_stride, pad=pad, channels=1,
                               with_path=with_path)
        assert len(self.hr_set) == len(self.lr_set)

    def __getitem__(self, index):
        if self.with_path:
            hr_sig, hr_path = self.hr_set[index]
            lr_sig, lr_path = self.lr_set[index]
        else:
            hr_sig = self.hr_set[index]
            lr_sig = self.lr_set[index]
        if self.upsample:
            lr_sig = resample_np(lr_sig, self.lr_sr, self.hr_sr)
            lr_sig = match_signal(lr_sig, hr_sig.shape[-1])
        if self.stft:
            hr_sig = self._spectrogram(hr_sig)
            lr_sig = self._spectrogram(lr_sig)
        if self.with_path:
            return (lr_sig, lr_path), (hr_sig, hr_path)
        return lr_sig, hr_sig

    def _spectrogram(self, sig: np.ndarray) -> np.ndarray:
        """Complex STFT (not normalised, centered, reflect) of [C, T] as
        [2C, F, T] with real and imaginary parts interleaved, or
        [C, F, T, 2]."""
        import torch

        from aero_tpu_torch.ops.spec import stft

        with torch.no_grad():
            z = stft(torch.from_numpy(np.ascontiguousarray(sig, np.float32)),
                     self.n_fft, self.hop_length, self.window_length)
        re = z.real.numpy().astype(np.float32)
        im = z.imag.numpy().astype(np.float32)
        if self.complex_as_channels:
            ch, fr, t = re.shape
            out = np.empty((2 * ch, fr, t), np.float32)
            out[0::2] = re
            out[1::2] = im
            return out
        return np.stack([re, im], axis=-1)

    def __len__(self):
        return len(self.lr_set)


class PrHrSet:
    """Reads ``*_lr/_hr/_pr.wav`` triples from a samples directory for
    offline evaluation; ``filenames`` selects stems by exact match."""

    def __init__(self, samples_dir, filenames=None):
        self.samples_dir = samples_dir
        files = os.listdir(samples_dir) if os.path.isdir(samples_dir) else []
        if filenames is not None:
            wanted = {f"{j}_{kind}.wav" for j in filenames
                      for kind in ("lr", "hr", "pr")}
            files = [i for i in files if i in wanted]
        self.hr_filenames = sorted(f for f in files if f.endswith("_hr.wav"))
        self.lr_filenames = sorted(f for f in files if f.endswith("_lr.wav"))
        self.pr_filenames = sorted(f for f in files if f.endswith("_pr.wav"))

    def __len__(self):
        return len(self.hr_filenames)

    def __getitem__(self, i):
        def load(name):
            return audio_io.load(os.path.join(self.samples_dir, name))[0]

        lr_i = load(self.lr_filenames[i])
        hr_i = load(self.hr_filenames[i])
        pr_i = match_signal(load(self.pr_filenames[i]), hr_i.shape[-1])
        names = {f[:f.rindex("_")] for f in (
            self.lr_filenames[i], self.hr_filenames[i], self.pr_filenames[i])}
        assert len(names) == 1, names
        return lr_i, hr_i, pr_i, names.pop()
