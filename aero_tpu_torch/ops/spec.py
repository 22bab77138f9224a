"""STFT / iSTFT with the reference wrapper's semantics (port of ``aero_tpu/ops/spec.py``).

``torch.stft``/``torch.istft`` with ``center=True``, reflect padding,
``normalized=True`` and a periodic Hann window of ``win_length`` that torch
zero-pads symmetrically to ``n_fft``. Always float32 / complex64.
"""

from __future__ import annotations

import torch


def _window(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def spectro(x, n_fft: int = 512, hop_length=None, pad: int = 0,
            win_length=None):
    """[..., T] real -> complex [..., n_fft // 2 + 1, frames]."""
    *lead, length = x.shape
    win_length = win_length or n_fft
    z = torch.stft(x.reshape(-1, length).float(), n_fft * (1 + pad),
                   hop_length or n_fft // 4, win_length=win_length,
                   window=_window(win_length, x.device), center=True,
                   pad_mode="reflect", normalized=True, return_complex=True)
    return z.reshape(*lead, *z.shape[-2:])


def ispectro(z, hop_length=None, length=None, pad: int = 0, win_length=None):
    """complex [..., freqs, frames] -> real [..., T]."""
    *lead, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    win_length = win_length or n_fft // (1 + pad)
    x = torch.istft(z.reshape(-1, freqs, frames), n_fft,
                    hop_length or n_fft // 2, win_length=win_length,
                    window=_window(win_length, z.device), center=True,
                    normalized=True, length=length)
    return x.reshape(*lead, x.shape[-1])
