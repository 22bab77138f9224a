"""Seanet, the time-domain baseline generator (port of
``aero_tpu/models/seanet.py``).

An encoder and a decoder of weight-normed convs with residual blocks, the
input divided by ``floor + std`` (ddof 1), upsampled inside the forward
by the sinc resample when ``upsample`` (the model's own kwarg; the
dataset's ``upsample`` stays false), zero-padded to the nearest valid
conv length, a skip from every encoder input to the matching decoder
output, then cut to the target length and multiplied back by the std.
Layout ``[B, C, T]``.

Submodule names are the reference state_dict keys (``encoder.0.1``,
``encoder.{i+1}.{j}.block.2/.4/.shortcut``, ``decoder.{i+1}.1``, ...,
as ``aero_tpu/train/torch_import.py::import_seanet_state`` reads them),
so a reference ``.th`` loads with ``load_state_dict``. The weight norm
is computed in float32 and the convs run in ``compute_dtype``.

For an odd ratio the decoder's transposed conv has an output_padding
sample, which the JAX package fills with the bias alone, where torch's
``conv_transpose1d`` (and so the reference) computes it like any other;
the port follows the JAX package. No shipped config has an odd ratio.
"""

from __future__ import annotations

import math
import typing as tp

import torch
from torch import nn

from aero_tpu_torch.models.discriminators import (
    WNConv1d, WNConvTranspose1d, _LeakyReLU, _ReflectionPad)
from aero_tpu_torch.ops.resample import resample


class ResnetBlock(nn.Module):
    """leaky ReLU 0.2, reflect pad by the dilation, a dilated k 3 conv,
    leaky ReLU, a 1x1 conv; plus a 1x1 shortcut of the input."""

    def __init__(self, dim: int, dilation: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        self.block = nn.Sequential(
            _LeakyReLU(), _ReflectionPad(dilation),
            WNConv1d(dim, dim, 3, dilation=dilation, **kw), _LeakyReLU(),
            WNConv1d(dim, dim, 1, **kw))
        self.shortcut = WNConv1d(dim, dim, 1, **kw)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class _Tanh(nn.Module):
    def forward(self, x):
        return torch.tanh(x)


class Seanet(nn.Module):
    """The JAX package's ``Seanet`` with the same kwargs (``resample`` is
    accepted and unused there too)."""

    def __init__(self, latent_space_size: int = 128, ngf: int = 32,
                 n_residual_layers: int = 3, resample: int = 1,
                 normalize: bool = True, floor: float = 1e-3,
                 ratios: tp.Sequence[int] = (8, 8, 2, 2),
                 in_channels: int = 1, out_channels: int = 1,
                 lr_sr: int = 16000, hr_sr: int = 16000,
                 upsample: bool = True, compute_dtype=torch.float32):
        super().__init__()
        self.ratios = tuple(ratios)
        self.normalize, self.floor = normalize, floor
        self.lr_sr, self.hr_sr, self.upsample = lr_sr, hr_sr, upsample
        kw = dict(compute_dtype=compute_dtype)
        n = len(self.ratios)
        mult = 2 ** n

        encoder = [nn.Sequential(_ReflectionPad(3),
                                 WNConv1d(in_channels, ngf, 7, **kw), _Tanh())]
        for i in range(n):
            r = self.ratios[n - 1 - i]
            m = 2 ** (i + 1)
            dim = m * ngf // 2
            encoder.append(nn.Sequential(
                *(ResnetBlock(dim, 3 ** j, **kw)
                  for j in range(n_residual_layers)),
                _LeakyReLU(),
                WNConv1d(dim, m * ngf, r * 2, r, r // 2 + r % 2, **kw)))
        encoder.append(nn.Sequential(
            _LeakyReLU(), _ReflectionPad(3),
            WNConv1d(mult * ngf, latent_space_size, 7, **kw)))
        self.encoder = nn.ModuleList(encoder)

        decoder = [nn.Sequential(
            _LeakyReLU(), _ReflectionPad(3),
            WNConv1d(latent_space_size, mult * ngf, 7, **kw))]
        for i, r in enumerate(self.ratios):
            m = 2 ** (n - i)
            decoder.append(nn.Sequential(
                _LeakyReLU(),
                WNConvTranspose1d(m * ngf, m * ngf // 2, r * 2, r,
                                  r // 2 + r % 2, r % 2, **kw),
                *(ResnetBlock(m * ngf // 2, 3 ** j, **kw)
                  for j in range(n_residual_layers))))
        decoder.append(nn.Sequential(
            _LeakyReLU(), _ReflectionPad(3),
            WNConv1d(ngf, out_channels, 7, **kw), _Tanh()))
        self.decoder = nn.ModuleList(decoder)

    @property
    def scale_factor(self) -> int:
        return int(self.hr_sr / self.lr_sr)

    def estimate_output_length(self, length: int) -> int:
        """The nearest length that the strided convs map back to itself."""
        for r in reversed(self.ratios):
            length = math.ceil((length - 2 * r + 2 * (r // 2 + r % 2)) / r)
            length = max(length + 1, 1)
        for r in self.ratios:
            length = (length - 1) * r + 2 * r - 2 * (r // 2 + r % 2) + r % 2
        return int(length)

    def forward(self, signal):
        """signal [B, C, T] (or [B, T]) -> [B, out, T * scale_factor]."""
        if signal.dim() == 2:
            signal = signal[:, None]
        x = signal
        target_len = x.shape[-1] * (self.scale_factor if self.upsample else 1)
        std = 1.0
        if self.normalize:
            mono = x.mean(dim=1, keepdim=True)
            std = mono.std(dim=-1, keepdim=True, unbiased=True)
            x = x / (self.floor + std)
        if self.upsample:
            x = resample(x, self.lr_sr, self.hr_sr)
        x = nn.functional.pad(
            x, (0, self.estimate_output_length(x.shape[-1]) - x.shape[-1]))
        skips = []
        for stage in self.encoder:
            skips.append(x)
            x = stage(x)
        for stage in self.decoder:
            x = stage(x) + skips.pop()
        return std * x[..., :target_len]
