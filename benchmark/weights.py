"""The benchmark's weights: drawn from ``--seed`` on the device, in two
large draws (one uniform, one normal), then shaped leaf by leaf.

The distributions are PyTorch's defaults, as the configuration's training
starts from them: U(+-1/sqrt(fan_in)) for convolutions, products and their
biases, U(+-1/sqrt(H)) for the LSTM, Exponential(0.1) for Snake's ``a``, a
smoothed N(0, 1) embedding, the LocalState decay query's 0.01 weight and
-2 bias, the Aero ``rescale`` of every Conv1d, and ``g = ||v||`` of the
weight-normed MelGAN convolutions. Three depart from a fresh
initialisation, so that every branch the comparison covers carries signal,
as in a trained model: norm gains U(0.8, 1.2) and shifts U(-0.1, 0.1),
BatchNorm running statistics U(-0.1, 0.1) / U(0.5, 1.5), and LayerScale
U(0.05, 0.25) in place of the configuration's ``dconv_init`` (1e-3, at
which the DConv branch, with the LSTM and the attention in it, adds a
thousandth of its input).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference import models as R


def _leaves(model: nn.Module):
    """(module, parameter or buffer name) in a fixed order."""
    for module in model.modules():
        for name, _ in module.named_parameters(recurse=False):
            yield module, name
        for name, _ in module.named_buffers(recurse=False):
            yield module, name


@torch.no_grad()
def fill_(models, seed: int) -> None:
    """Fill the reference ``models`` (``build_reference``) in place from
    ``seed``, on their device."""
    nets = [models["generator"], models["msd_melgan"]]
    device = next(nets[0].parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    leaves = [(m, n) for net in nets for m, n in _leaves(net)]
    total = sum(getattr(m, n).numel() for m, n in leaves)
    emb = [m.embedding.weight for net in nets for m in net.modules()
           if isinstance(m, R.ScaledEmbedding)]
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(sum(w.numel() for w in emb), generator=gen,
                         device=device)
    offset = 0
    for m, n in leaves:
        t = getattr(m, n)
        u = uniform[offset:offset + t.numel()].view_as(t)
        offset += t.numel()
        t.copy_(_draw(m, n, t, u))
    offset = 0
    for m in (m for net in nets for m in net.modules()
              if isinstance(m, R.ScaledEmbedding)):
        w = m.embedding.weight
        z = normal[offset:offset + w.numel()].view_as(w)
        offset += w.numel()
        rows = torch.arange(1, w.shape[0] + 1, dtype=w.dtype, device=device)
        w.copy_(z.cumsum(0) / rows.sqrt()[:, None] / m.scale)
    for m in nets[0].modules():
        if isinstance(m, R.LocalState):
            m.query_decay.weight.mul_(0.01)
            m.query_decay.bias.fill_(-2.0)
    for m in nets[0].modules():
        if isinstance(m, nn.Conv1d):
            scale = (m.weight.std(unbiased=False) / 0.1).sqrt()
            m.weight.div_(scale)
            m.bias.div_(scale)
    for m in nets[1].modules():
        if isinstance(m, R.WNConv1d):
            m.weight_g.copy_(m.weight_v.pow(2).sum(dim=(1, 2), keepdim=True)
                             .sqrt())


def _draw(m, name, t, u):
    """Leaf ``name`` of module ``m`` from ``u`` ~ U[0, 1) of its shape."""
    sym = 2 * u - 1
    if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        return sym / math.sqrt(m.weight[0].numel())
    if isinstance(m, R.WNConv1d):
        return sym / math.sqrt(m.weight_v[0].numel())
    if isinstance(m, nn.LSTM):
        return sym / math.sqrt(m.hidden_size)
    if isinstance(m, (nn.GroupNorm, R.BatchNorm)):
        return {"weight": 1 + 0.2 * sym, "bias": 0.1 * sym,
                "running_mean": 0.1 * sym, "running_var": 1 + 0.5 * sym}[name]
    if isinstance(m, R.Snake):
        return -torch.log1p(-u) / 0.1
    if isinstance(m, R.LayerScale):
        return 0.05 + 0.2 * u
    if isinstance(m, nn.Embedding):
        return torch.zeros_like(t)  # drawn from the normal draw
    raise TypeError(f"no draw for {type(m).__name__}.{name}")


def seeded_reference(cfg, seed: int, device, quant=R.exact):
    """The reference models of ``cfg`` with the weights of ``seed``."""
    models = R.build_reference(cfg, device, quant)
    fill_(models, seed)
    return models
