"""The MelGAN multi-scale discriminator in PyTorch (port of
``aero_tpu/models/discriminators.py:87-127,261-285,309-409``).

Layouts are PyTorch's: waveforms and feature maps ``[B, C, T]`` (the JAX
discriminators are channels-last). Submodule names reproduce the reference
state_dict keys (``model.disc_i.model.layer_n[.0|.1].weight_v/weight_g/
bias``, as ``train.from_jax.melgan_torch_prefix`` names them), so a
reference ``.th`` discriminator loads with ``load_state_dict``.

Weights are float32; the weight norm is computed in float32 and the convs
run in ``compute_dtype`` with plain ``groups=`` (the TPU's block-diagonal
``grouped_conv1d`` is a lowering workaround and is not carried over).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.2


class WNConv1d(nn.Module):
    """Weight-normalised conv1d: ``w = v * g / max(||v||, 1e-12)`` with the
    norm per output channel (``discriminators.py:87-127``)."""

    def __init__(self, chin: int, chout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = compute_dtype
        self.weight_v = nn.Parameter(
            torch.empty(chout, chin // groups, kernel_size))
        self.weight_g = nn.Parameter(torch.ones(chout, 1, 1))
        self.bias = nn.Parameter(torch.zeros(chout))

    def weight(self):
        v = self.weight_v
        norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        return v * (self.weight_g / norm.clamp_min(1e-12))

    def forward(self, x):
        cd = self.compute_dtype
        return F.conv1d(x.to(cd), self.weight().to(cd), self.bias.to(cd),
                        self.stride, self.padding, groups=self.groups)


class _LeakyReLU(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, LEAKY_SLOPE)


class _ReflectionPad(nn.Module):
    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return F.pad(x, (self.pad, self.pad), mode="reflect")


class NLayerDiscriminator(nn.Module):
    """One MelGAN scale (``discriminators.py:309-376``). Returns every
    layer's feature map, the logits last."""

    def __init__(self, ndf: int, n_layers: int, downsampling_factor: int,
                 compute_dtype=torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        layers = {"layer_0": nn.Sequential(
            _ReflectionPad(7), WNConv1d(1, ndf, 15, **kw), _LeakyReLU())}
        nf, stride = ndf, downsampling_factor
        max_nf = stride ** (n_layers - 1) * ndf
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * stride, max_nf)
            layers[f"layer_{n}"] = nn.Sequential(
                WNConv1d(nf_prev, nf, stride * 10 + 1, stride, stride * 5,
                         groups=nf_prev // 4, **kw), _LeakyReLU())
        nf_prev, nf = nf, min(nf * 2, max_nf)
        layers[f"layer_{n_layers + 1}"] = nn.Sequential(
            WNConv1d(nf_prev, nf, 5, padding=2, **kw), _LeakyReLU())
        layers[f"layer_{n_layers + 2}"] = WNConv1d(nf, 1, 3, padding=1, **kw)
        self.model = nn.ModuleDict(layers)

    def forward(self, x):
        results = []
        for layer in self.model.values():
            x = layer(x)
            results.append(x)
        return results


class MelganDiscriminator(nn.Module):
    """MelGAN multi-scale discriminator (``discriminators.py:379-409``):
    ``num_D`` scales, each fed the previous scale's input through
    ``avg_pool1d(4, 2, 1, count_include_pad=False)``. Input ``[B, 1, T]``;
    returns one feature-map list per scale."""

    def __init__(self, num_D: int, ndf: int, n_layers: int,
                 downsampling_factor: int, compute_dtype=torch.float32):
        super().__init__()
        self.n_layers = n_layers
        self.model = nn.ModuleDict({
            f"disc_{i}": NLayerDiscriminator(ndf, n_layers,
                                             downsampling_factor,
                                             compute_dtype)
            for i in range(num_D)})

    def forward(self, x):
        results = []
        for disc in self.model.values():
            results.append(disc(x))
            x = F.avg_pool1d(x, 4, 2, 1, count_include_pad=False)
        return results
