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


def stft_loss(x, y, fft_size: int, hop_size: int, win_length: int,
              all_sum: tp.Optional[tp.Callable] = None):
    """Single-resolution (spectral convergence, log-magnitude) losses.

    The spectral convergence ``||y - x||_F / ||y||_F`` is one ratio over the
    whole batch: with ``all_sum`` (``parallel.mesh.all_sum``, when the batch
    is sharded over ranks) its two squared sums span every rank's rows
    before the roots. The log-magnitude term is a mean, which the ranks'
    gradient average already makes global."""
    x_mag = stft_magnitude(x, fft_size, hop_size, win_length)
    y_mag = stft_magnitude(y, fft_size, hop_size, win_length)
    sums = torch.stack([torch.sum((y_mag - x_mag) ** 2),
                        torch.sum(y_mag ** 2)])
    if all_sum is not None:
        sums = all_sum(sums)
    sc = torch.sqrt(sums[0]) / torch.sqrt(sums[1])
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


def multi_resolution_stft_loss(
    x, y,
    fft_sizes: tp.Sequence[int] = (1024, 2048, 512),
    hop_sizes: tp.Sequence[int] = (120, 240, 50),
    win_lengths: tp.Sequence[int] = (600, 1200, 240),
    factor_sc: float = 0.1,
    factor_mag: float = 0.1,
    all_sum: tp.Optional[tp.Callable] = None,
):
    """x, y: [B, T] predicted / ground truth. Returns (sc_loss, mag_loss),
    each the mean over resolutions times its factor (``all_sum``: see
    ``stft_loss``)."""
    sc_loss = mag_loss = 0.0
    for fs, ss, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, ss, wl, all_sum)
        sc_loss = sc_loss + sc
        mag_loss = mag_loss + mag
    n = len(fft_sizes)
    return factor_sc * sc_loss / n, factor_mag * mag_loss / n
