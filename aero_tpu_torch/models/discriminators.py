"""The GAN discriminators in PyTorch: the MelGAN multi-scale discriminator
and HiFi-GAN's multi-period and multi-scale ones, with the weight- and
spectral-normed convs they and Seanet are built of (port of
``aero_tpu/models/discriminators.py:87-259,309-409,426-643``).

Layouts are PyTorch's: waveforms and feature maps ``[B, C, T]``, the
period discriminator's folded maps ``[B, C, T / p, p]`` (the JAX
discriminators are channels-last). Submodule names reproduce the reference
state_dict keys: ``model.disc_i.model.layer_n[.0|.1].weight_v/weight_g/
bias`` for the MelGAN (as ``train.from_jax.melgan_torch_prefix`` names
them), ``discriminators.i.convs.j`` and ``discriminators.i.conv_post`` for
HiFi's, with ``weight_orig``/``weight_u`` on the spectral-normed scale.

Weights are float32; the weight norm and the power iteration are computed
in float32 and the convs run in ``compute_dtype`` with plain ``groups=``
(the TPU's block-diagonal ``grouped_conv1d`` and the ``AERO_CONVGRAD=poly``
gradient are lowering workarounds and are not carried over, nor is the
``n_valid`` masking of the TPU's bucketed valid step).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aero_tpu_torch.utils.profiling import annotate

LEAKY_SLOPE = 0.2   # MelGAN and Seanet
LRELU_SLOPE = 0.1   # HiFi-GAN


class _WeightNorm(nn.Module):
    """``w = v * g / max(||v||, 1e-12)``, the norm over every axis of
    ``weight_v`` but the first (torch's ``weight_norm(dim=0)``: the output
    channel of a conv, the input channel of a transposed conv)."""

    def _init_weights(self, shape, chout: int, compute_dtype):
        self.compute_dtype = compute_dtype
        self.weight_v = nn.Parameter(torch.empty(shape))
        self.weight_g = nn.Parameter(torch.ones((shape[0],)
                                                + (1,) * (len(shape) - 1)))
        self.bias = nn.Parameter(torch.zeros(chout))

    def weight(self):
        v = self.weight_v
        norm = v.pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
        return v * (self.weight_g / norm.clamp_min(1e-12))

    def _cast(self):
        cd = self.compute_dtype
        return self.weight().to(cd), self.bias.to(cd)


class WNConv1d(_WeightNorm):
    """Weight-normalised conv1d, the norm per output channel
    (``discriminators.py:87-127``)."""

    def __init__(self, chin: int, chout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 dilation: int = 1, compute_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dilation = dilation
        self._init_weights((chout, chin // groups, kernel_size), chout,
                           compute_dtype)

    def forward(self, x):
        w, b = self._cast()
        return F.conv1d(x.to(self.compute_dtype), w, b, self.stride,
                        self.padding, self.dilation, self.groups)


class WNConvTranspose1d(_WeightNorm):
    """Weight-normalised transposed conv1d (``discriminators.py:130-166``):
    weight ``[in, out, k]``, so the norm and ``g`` are per INPUT channel.

    The ``output_padding`` samples are zeros plus the bias, as the JAX
    package computes them (``discriminators.py:161-165``); torch's
    ``ConvTranspose1d`` would fill them from the kernel instead."""

    def __init__(self, chin: int, chout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 compute_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self._init_weights((chin, chout, kernel_size), chout, compute_dtype)

    def forward(self, x):
        w, b = self._cast()
        y = F.conv_transpose1d(x.to(self.compute_dtype), w, None, self.stride,
                               self.padding)
        if self.output_padding:
            y = F.pad(y, (0, self.output_padding))
        return y + b[:, None]


class WNConv2d(_WeightNorm):
    """Weight-normalised conv2d, the norm per output channel over (in, kh,
    kw) (``discriminators.py:169-193``)."""

    def __init__(self, chin: int, chout: int, kernel_size, stride=(1, 1),
                 padding=(0, 0), compute_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self._init_weights((chout, chin, *kernel_size), chout, compute_dtype)

    def forward(self, x):
        w, b = self._cast()
        return F.conv2d(x.to(self.compute_dtype), w, b, self.stride,
                        self.padding)


class SNConv1d(nn.Module):
    """Spectral-normalised conv1d (``discriminators.py:218-258``):
    ``w / sigma`` with sigma from ONE power iteration on ``W =
    weight_orig.reshape(out, -1)`` from the stored ``weight_u``, on every
    call (train or eval alike): ``v = normalize(W^T u)``, ``u' =
    normalize(W v)``, ``sigma = u'^T W v`` with u' and v constants, so the
    gradient reaches W through sigma. ``store=True`` keeps u' in
    ``weight_u``; nothing else stores it (not ``self.training``). v is not
    kept: each call recomputes it. ``SNConv1d.power_iterations`` counts
    the iterations of every instance (a forward's and ``step_u``'s)."""

    power_iterations = 0

    def __init__(self, chin: int, chout: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.compute_dtype = compute_dtype
        self.weight_orig = nn.Parameter(
            torch.empty(chout, chin // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(chout))
        self.register_buffer("weight_u", torch.ones(chout))

    @torch.no_grad()
    def _power_iteration(self):
        """(u', v) of one iteration from the stored u."""
        SNConv1d.power_iterations += 1
        w = self.weight_orig.reshape(self.weight_orig.shape[0], -1)
        v = F.normalize(w.t() @ self.weight_u, dim=0, eps=1e-12)
        return F.normalize(w @ v, dim=0, eps=1e-12), v

    @torch.no_grad()
    def step_u(self):
        """Store one power iteration from the stored u, without a forward."""
        self.weight_u.copy_(self._power_iteration()[0])

    def forward(self, x, store: bool = False):
        u, v = self._power_iteration()
        if store:
            with torch.no_grad():
                self.weight_u.copy_(u)
        w = self.weight_orig
        sigma = torch.dot(u, w.reshape(w.shape[0], -1) @ v)
        cd = self.compute_dtype
        return F.conv1d(x.to(cd), (w / sigma).to(cd), self.bias.to(cd),
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


class DiscriminatorP(nn.Module):
    """HiFi-GAN period discriminator (``discriminators.py:430-505``): the
    waveform reflect-padded at its end to a multiple of ``period``, viewed
    as ``[B, C, T / p, p]``, then (5, 1) convs of widths hidden x (1, 4,
    16, 32) with stride (3, 1), one more at stride 1 and ``conv_post``.
    Returns (logits [B, rows * p] row-major, the feature maps, logits'
    map last)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 hidden: int = 32, compute_dtype=torch.float32):
        super().__init__()
        self.period = period
        kw = dict(compute_dtype=compute_dtype)
        pad = (kernel_size - 1) // 2  # get_padding(5, 1)
        widths = [1, hidden, hidden * 4, hidden * 16, hidden * 32]
        self.convs = nn.ModuleList(
            [WNConv2d(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0),
                      **kw) for cin, cout in zip(widths, widths[1:])]
            + [WNConv2d(hidden * 32, hidden * 32, (kernel_size, 1), (1, 1),
                        (2, 0), **kw)])
        self.conv_post = WNConv2d(hidden * 32, 1, (3, 1), (1, 1), (1, 0),
                                  **kw)

    def forward(self, x):
        b, c, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x, (0, p - t % p), mode="reflect")
        x = x.reshape(b, c, -1, p)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class _HifiDiscriminator(nn.Module):
    """``forward(y, y_hat)`` as the JAX module's: (real logits, fake
    logits, real feature maps, fake feature maps), one entry per
    sub-discriminator, from ``discriminate`` of each input in turn."""

    def forward(self, y, y_hat, **kw):
        real_logits, real_fmaps = self.discriminate(y, **kw)
        fake_logits, fake_fmaps = self.discriminate(y_hat, **kw)
        return real_logits, fake_logits, real_fmaps, fake_fmaps


class MultiPeriodDiscriminator(_HifiDiscriminator):
    """HiFi-GAN MPD (``discriminators.py:508-541``), one ``DiscriminatorP``
    per period."""

    def __init__(self, hidden: int = 32, periods=(2, 3, 5, 7, 11),
                 compute_dtype=torch.float32):
        super().__init__()
        self.periods = tuple(periods)
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, hidden=hidden, compute_dtype=compute_dtype)
            for p in self.periods)

    def discriminate(self, x):
        """([logits per period], [feature maps per period]) of ``x``; the
        span ``hifi.mpd`` under a profiler."""
        logits, fmaps = [], []
        with annotate("hifi.mpd"):
            for d in self.discriminators:
                y, fmap = d(x)
                logits.append(y)
                fmaps.append(fmap)
        return logits, fmaps


class DiscriminatorS(nn.Module):
    """HiFi-GAN scale discriminator (``discriminators.py:544-594``): seven
    grouped convs with leaky ReLU 0.1 and ``conv_post``, all
    spectral-normed (``SNConv1d``) or all weight-normed."""

    def __init__(self, use_spectral_norm: bool = False, hidden: int = 128,
                 compute_dtype=torch.float32):
        super().__init__()
        hd = hidden
        # (in, out, kernel, stride, padding, groups)
        specs = [(1, hd, 15, 1, 7, 1), (hd, hd, 41, 2, 20, 4),
                 (hd, hd * 2, 41, 2, 20, 16), (hd * 2, hd * 4, 41, 4, 20, 16),
                 (hd * 4, hd * 8, 41, 4, 20, 16),
                 (hd * 8, hd * 8, 41, 1, 20, 16), (hd * 8, hd * 8, 5, 1, 2, 1)]
        conv = SNConv1d if use_spectral_norm else WNConv1d
        self.spectral = use_spectral_norm
        kw = dict(compute_dtype=compute_dtype)
        self.convs = nn.ModuleList(
            conv(cin, cout, k, s, p, groups=g, **kw)
            for cin, cout, k, s, p, g in specs)
        self.conv_post = conv(hd * 8, 1, 3, 1, 1, **kw)

    def forward(self, x, store: bool = False):
        kw = dict(store=store) if self.spectral else {}
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, **kw), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, **kw)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiScaleDiscriminator(_HifiDiscriminator):
    """HiFi-GAN MSD (``discriminators.py:597-643``): ``num_D`` scales, the
    first spectral-normed, each later one fed the previous scale's input
    through ``avg_pool1d(4, 2, padding=2)`` counting the padding (unlike
    the MelGAN's pool)."""

    def __init__(self, hidden: int = 64, num_D: int = 3,
                 compute_dtype=torch.float32):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=i == 0, hidden=hidden,
                           compute_dtype=compute_dtype)
            for i in range(num_D))

    def discriminate(self, x, store: bool = False):
        """([logits per scale], [feature maps per scale]) of ``x``;
        ``store``: the spectral-normed convs keep their new u. In JAX a
        storing call runs the real input and then the fake one through
        each scale, so the fake forward reads the u the real one stored;
        ``forward(y, y_hat, store=True)`` does the same. The span
        ``hifi.msd`` under a profiler."""
        logits, fmaps = [], []
        with annotate("hifi.msd"):
            for i, d in enumerate(self.discriminators):
                if i:
                    x = F.avg_pool1d(x, 4, 2, 2)
                y, fmap = d(x, store)
                logits.append(y)
                fmaps.append(fmap)
        return logits, fmaps

    def step_u(self):
        """Store one power iteration in every spectral-normed conv, as a
        storing forward would, without running one."""
        for m in self.modules():
            if isinstance(m, SNConv1d):
                m.step_u()
