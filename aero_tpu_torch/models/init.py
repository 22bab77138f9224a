"""Seeded initialisation of the port's networks (port of
``aero_tpu/models/init.py`` and the inits of ``aero_tpu/models/discriminators.py``
and ``aero_tpu/models/seanet.py``).

Every draw goes through one explicit ``torch.Generator``, so a seed gives the
same weights on any device. The distributions are PyTorch's defaults, as the
JAX package reproduces them:

- Conv / ConvTranspose / Linear: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the
  weight and the bias (``kaiming_uniform(a=sqrt(5))``), with torch's fan_in
  (a transposed conv's is out_channels * prod(kernel));
- LSTM: U(-1/sqrt(hidden), 1/sqrt(hidden)) for every weight and bias;
- norms: ones and zeros, running mean 0 and variance 1;
- Snake ``a``: Exponential(rate 0.1); LayerScale: its ``init_value``;
- ScaledEmbedding: N(0, 1), smoothed by a cumulative sum over rows divided
  by sqrt(row + 1) when ``smooth``, then divided by ``scale``;
- LocalState ``query_decay``: weight times 0.01, bias -2;
- then the Aero rescale: every Conv1d weight and bias divided by
  sqrt(std(weight) / reference) (``init.py:96``, ``train/build.py:45-47``);
- the weight-normed convs of the MelGAN, HiFi and Seanet: ``v`` and the
  bias as a Conv or ConvTranspose above, ``g = ||v||`` over the axes the
  norm takes, so that the initial weight is ``v``
  (``discriminators.py:87-193``);
- HiFi's spectral-normed convs: the weight and bias as a Conv above, the
  power iteration's ``u`` a standard normal draw, not normalised
  (``discriminators.py:218-242``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from aero_tpu_torch.models import discriminators as D
from aero_tpu_torch.models import modules as M


@torch.no_grad()
def init_aero_(model: nn.Module, generator: torch.Generator,
               rescale: float = 0.1) -> nn.Module:
    """Initialise ``model`` in place from ``generator``; returns it."""
    for module in model.modules():
        if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d,
                               nn.Linear)):
            # torch's fan_in: in * prod(kernel) for [out, in, *k] and
            # [out, in]; out * prod(kernel) for a transposed [in, out, *k]
            bound = 1.0 / math.sqrt(module.weight[0].numel())
            module.weight.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, nn.LSTM):
            bound = 1.0 / math.sqrt(module.hidden_size)
            for p in module.parameters():
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, (nn.GroupNorm, M.BatchNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
            if isinstance(module, M.BatchNorm):
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        elif isinstance(module, M.Snake):
            module.a.exponential_(0.1, generator=generator)
        elif isinstance(module, M.LayerScale):
            module.scale.fill_(module.init_value)
        elif isinstance(module, M.ScaledEmbedding):
            w = module.embedding.weight
            w.normal_(0.0, 1.0, generator=generator)
            if module.smooth:
                rows = torch.arange(1, w.shape[0] + 1, dtype=w.dtype)
                w.copy_(w.cumsum(0) / rows.sqrt()[:, None])
            w.div_(module.scale)
    for module in model.modules():
        if isinstance(module, M.LocalState) and module.ndecay:
            module.query_decay.weight.mul_(0.01)
            module.query_decay.bias.fill_(-2.0)
    if rescale:
        for module in model.modules():
            if isinstance(module, nn.Conv1d):
                scale = (module.weight.std(unbiased=False) / rescale).sqrt()
                module.weight.div_(scale)
                if module.bias is not None:
                    module.bias.div_(scale)
    return model


@torch.no_grad()
def init_normed_convs_(model: nn.Module,
                       generator: torch.Generator) -> nn.Module:
    """Initialise every weight- and spectral-normed conv of ``model`` in
    place from ``generator``; returns it. The MelGAN, the HiFi
    discriminators and Seanet are made of nothing else."""
    for module in model.modules():
        if isinstance(module, D._WeightNorm):
            v = module.weight_v
            # torch's fan_in: v[0] is [in/groups, *k] of a conv and
            # [out, k] of a transposed conv
            bound = 1.0 / math.sqrt(v[0].numel())
            v.uniform_(-bound, bound, generator=generator)
            module.bias.uniform_(-bound, bound, generator=generator)
            module.weight_g.copy_(v.pow(2).sum(
                dim=tuple(range(1, v.dim())), keepdim=True).sqrt())
        elif isinstance(module, D.SNConv1d):
            w = module.weight_orig
            bound = 1.0 / math.sqrt(w[0].numel())
            w.uniform_(-bound, bound, generator=generator)
            module.bias.uniform_(-bound, bound, generator=generator)
            module.weight_u.normal_(0.0, 1.0, generator=generator)
    return model
