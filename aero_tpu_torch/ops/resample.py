"""Polyphase windowed-sinc resampling of a tensor on its device (port of
``aero_tpu/ops/resample.py::resample``; torchaudio's ``resample`` at its
defaults).

One strided ``conv1d`` with ``new_freq`` output channels, the polyphase
bank of ``data/resample.py``, then the phases interleaved and the result
cut to ``ceil(T * new / old)``. Always float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aero_tpu_torch.data.resample import _resample_kernel


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6,
             rolloff: float = 0.99) -> torch.Tensor:
    """Resample along the last axis: [..., T] -> [..., ceil(T*new/orig)]."""
    if orig_freq == new_freq:
        return x
    gcd = math.gcd(int(orig_freq), int(new_freq))
    of, nf = int(orig_freq) // gcd, int(new_freq) // gcd
    kernel, width = _resample_kernel(of, nf, lowpass_filter_width, rolloff)
    *lead, length = x.shape
    x2 = F.pad(x.reshape(-1, 1, length).float(), (width, width + of))
    y = F.conv1d(x2, torch.from_numpy(kernel).to(x.device), stride=of)
    y = y.transpose(1, 2).reshape(x2.shape[0], -1)  # interleave the phases
    target = math.ceil(nf * length / of)
    return y[:, :target].reshape(*lead, target)
