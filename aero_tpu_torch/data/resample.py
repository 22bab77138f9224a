"""Polyphase windowed-sinc resampling on the host, in numpy (copy of
``resample_np`` and ``_resample_kernel`` of ``aero_tpu/ops/resample.py``).

The reference resamples with ``torchaudio.functional.resample`` at its
defaults: ``lowpass_filter_width=6``, ``rolloff=0.99``, Hann-windowed sinc.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=32)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """(kernel [new_freq, 1, width*2 + orig_freq], width), as torchaudio's
    ``_get_sinc_resample_kernel`` for ``sinc_interp_hann`` (both rates
    already gcd-reduced)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None] / orig_freq
    t = np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    scale = base_freq / orig_freq
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * scale
    return kernel[:, None, :].astype(np.float32), width


def resample_np(x: np.ndarray, orig_freq: int, new_freq: int,
                lowpass_filter_width: int = 6,
                rolloff: float = 0.99) -> np.ndarray:
    """Resample along the last axis: [..., T] -> [..., ceil(T*new/orig)]."""
    if orig_freq == new_freq:
        return x
    gcd = math.gcd(int(orig_freq), int(new_freq))
    of, nf = int(orig_freq) // gcd, int(new_freq) // gcd
    kernel, width = _resample_kernel(of, nf, lowpass_filter_width, rolloff)
    kernel = kernel[:, 0, :]  # [nf, K]

    *lead, length = x.shape
    x2 = x.reshape(-1, length).astype(np.float32)
    x2 = np.pad(x2, ((0, 0), (width, width + of)))
    n_frames = (x2.shape[-1] - kernel.shape[-1]) // of + 1
    s0, s1 = x2.strides
    frames = np.lib.stride_tricks.as_strided(
        x2, (x2.shape[0], n_frames, kernel.shape[-1]), (s0, s1 * of, s1))
    y = np.einsum("bfk,pk->bfp", frames, kernel).reshape(x2.shape[0], -1)
    tgt = math.ceil(nf * length / of)
    return y[:, :tgt].reshape(*lead, tgt)
