"""The benchmark's weights of the HiFi configuration: the generator drawn
from ``--seed`` exactly as ``benchmark.weights`` draws it, the MSD and the
MPD from a second stream of the same seed, in one uniform draw shaped leaf
by leaf, on the device.

PyTorch's defaults, as the configuration's training starts from them:
``v`` of every weight-normed convolution (and the spectral-normed scale's
``weight_orig``) and every bias U(+-1/sqrt(fan_in)), ``g = ||v||`` per
output channel, and each stored ``weight_u`` a unit vector.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from benchmark import weights
from benchmark.reference import hifi as H
from benchmark.reference import models as R


def _stream(seed: int) -> int:
    """The discriminators' seed: another stream of ``seed``."""
    a, b = np.random.SeedSequence([int(seed), 1]).generate_state(2)
    return (int(a) << 31 | int(b) >> 1) % 2 ** 63


def _draw(m, name, u):
    sym = 2 * u - 1
    if isinstance(m, (H.WNConv2d, R.WNConv1d)):
        return sym / math.sqrt(m.weight_v[0].numel())
    if isinstance(m, H.SNConv1d):
        if name == "weight_u":
            return sym / sym.norm().clamp_min(1e-12)
        return sym / math.sqrt(m.weight_orig[0].numel())
    raise TypeError(f"no draw for {type(m).__name__}.{name}")


@torch.no_grad()
def fill_(models, seed: int) -> None:
    """Fill the reference ``models`` (``reference.hifi.build_reference``)
    in place from ``seed``, on their device."""
    weights.fill_({"generator": models["generator"],
                   "msd_melgan": nn.Module()}, seed)
    nets = [models["msd_hifi"], models["mpd"]]
    device = next(nets[0].parameters()).device
    gen = torch.Generator(device=device).manual_seed(_stream(seed))
    leaves = [(m, n) for net in nets for m, n in weights._leaves(net)]
    uniform = torch.rand(sum(getattr(m, n).numel() for m, n in leaves),
                         generator=gen, device=device)
    offset = 0
    for m, n in leaves:
        t = getattr(m, n)
        t.copy_(_draw(m, n, uniform[offset:offset + t.numel()].view_as(t)))
        offset += t.numel()
    for net in nets:
        for m in net.modules():
            if isinstance(m, (H.WNConv2d, R.WNConv1d)):
                v = m.weight_v
                m.weight_g.copy_(v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                              keepdim=True).sqrt())


def seeded_reference(cfg, seed: int, device, quant=R.exact):
    """The reference models of the HiFi ``cfg`` with the weights of
    ``seed``."""
    models = H.build_reference(cfg, device, quant)
    fill_(models, seed)
    return models
