"""Mel spectrogram for the HiFi mel loss (port of ``aero_tpu/ops/mel.py``).

torchaudio's ``MelSpectrogram`` defaults, as the reference uses it: power
2, HTK mel scale, no filterbank norm, a centred reflect-padded STFT with a
Hann window. ``mel_filterbank`` is the JAX package's numpy code, so the
bank is the same bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aero_tpu_torch.ops.spec import stft


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   f_min: float = 0.0, f_max: float | None = None
                   ) -> np.ndarray:
    """HTK-scale triangular filterbank [n_freqs, n_mels] (torchaudio
    ``melscale_fbanks``)."""
    f_max = f_max or sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels+2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def mel_spectrogram(x, sample_rate: int, n_fft: int = 400,
                    win_length: int | None = None,
                    hop_length: int | None = None, n_mels: int = 128,
                    f_min: float = 0.0, f_max: float | None = None):
    """x: [..., T] -> [..., n_mels, frames], float32, on x's device; the
    power spectrum (power 2, the only one the configs use)."""
    win_length = win_length or n_fft
    hop_length = hop_length or win_length // 2
    z = stft(x, n_fft, hop_length, win_length)
    spec = z.real ** 2 + z.imag ** 2  # no sqrt for the square to undo
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, f_min,
                                         f_max)).to(x.device, spec.dtype)
    return torch.einsum("...ft,fm->...mt", spec, fb)
