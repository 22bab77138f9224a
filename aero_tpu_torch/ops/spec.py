"""STFT / iSTFT with the reference's semantics (port of ``aero_tpu/ops/spec.py``).

``torch.stft``/``torch.istft`` with ``center=True``, reflect padding and a
periodic Hann window of ``win_length`` that torch zero-pads symmetrically
to ``n_fft``; normalised in ``spectro``/``ispectro`` (the model's), not
in ``stft`` (the STFT loss's). Always float32 / complex64. In a FLOP
count each transform counts as the JAX package's DFT product
(``utils.flops.dft_flops``), and as much again for its gradient.
"""

from __future__ import annotations

import torch

from aero_tpu_torch.utils import flops


def _window(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def _stft(x, n_fft: int, hop_length: int, win_length: int,
          normalized: bool):
    """torch.stft with center=True and reflect padding, counted: [..., T]
    real -> complex [..., n_fft // 2 + 1, frames]."""
    *lead, length = x.shape
    rows = x.numel() // max(length, 1)

    def transform(x):
        z = torch.stft(x.reshape(-1, length).float(), n_fft, hop_length,
                       win_length=win_length,
                       window=_window(win_length, x.device), center=True,
                       pad_mode="reflect", normalized=normalized,
                       return_complex=True)
        return z.reshape(*lead, *z.shape[-2:])

    frames = 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_length
    fwd = flops.dft_flops(rows, frames, n_fft)
    return flops.counted("stft", fwd, fwd if x.requires_grad else 0,
                         transform, x)


def spectro(x, n_fft: int = 512, hop_length=None, pad: int = 0,
            win_length=None):
    """[..., T] real -> complex [..., n_fft // 2 + 1, frames]."""
    return _stft(x, n_fft * (1 + pad), hop_length or n_fft // 4,
                 win_length or n_fft, normalized=True)


def stft(x, n_fft: int, hop_length: int, win_length=None):
    """Non-normalised ``aero_tpu.ops.spec.stft`` (as the STFT loss calls
    it) with center=True and reflect padding: [..., T] real -> complex
    [..., n_fft // 2 + 1, frames]."""
    return _stft(x, n_fft, hop_length, win_length or n_fft,
                 normalized=False)


def ispectro(z, hop_length=None, length=None, pad: int = 0, win_length=None):
    """complex [..., freqs, frames] -> real [..., T]."""
    *lead, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    win_length = win_length or n_fft // (1 + pad)

    def transform(z):
        x = torch.istft(z.reshape(-1, freqs, frames), n_fft,
                        hop_length or n_fft // 2, win_length=win_length,
                        window=_window(win_length, z.device), center=True,
                        normalized=True, length=length)
        return x.reshape(*lead, x.shape[-1])

    fwd = flops.dft_flops(z.numel() // max(freqs * frames, 1), frames, n_fft)
    return flops.counted("stft", fwd, fwd if z.requires_grad else 0,
                         transform, z)
