"""Multi-resolution STFT loss (port of ``aero_tpu/losses/stft_loss.py:20-88``).

Spectral convergence plus log-magnitude L1 at the resolutions (1024, 120,
600), (2048, 240, 1200) and (512, 50, 240), on a non-normalised STFT with
center=True and reflect padding. The magnitude is
``sqrt(max(re^2 + im^2, 1e-7))``, written so (and not as ``abs``) so that
its gradient is the JAX package's.
"""

from __future__ import annotations

import typing as tp

import torch

from aero_tpu_torch.ops.spec import stft


def stft_magnitude(x, fft_size: int, hop_size: int, win_length: int):
    """x: [B, T] -> magnitude [B, freqs, frames] (float32)."""
    z = stft(x, fft_size, hop_size, win_length)
    return torch.sqrt(torch.clamp_min(z.real ** 2 + z.imag ** 2, 1e-7))


def stft_loss(x, y, fft_size: int, hop_size: int, win_length: int):
    """Single-resolution (spectral convergence, log-magnitude) losses."""
    x_mag = stft_magnitude(x, fft_size, hop_size, win_length)
    y_mag = stft_magnitude(y, fft_size, hop_size, win_length)
    sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.linalg.vector_norm(
        y_mag)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(
    x, y,
    fft_sizes: tp.Sequence[int] = (1024, 2048, 512),
    hop_sizes: tp.Sequence[int] = (120, 240, 50),
    win_lengths: tp.Sequence[int] = (600, 1200, 240),
    factor_sc: float = 0.1,
    factor_mag: float = 0.1,
):
    """x, y: [B, T] predicted / ground truth. Returns (sc_loss, mag_loss),
    each the mean over resolutions times its factor."""
    sc_loss = mag_loss = 0.0
    for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, ss, wl)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(fft_sizes)
    return factor_sc * sc_loss / n, factor_mag * mag_loss / n
