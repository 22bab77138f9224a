"""Plain PyTorch reference of AERO's GAN step against HiFi-GAN's
discriminators (Kong et al., arXiv:2010.05646, §2.2-2.3), in float32: the
multi-period discriminator (MPD), the multi-scale discriminator (MSD) with
its spectral-normed first scale, the LS-GAN, feature-matching and mel
losses, and ``ReferenceHifiStep``, which takes the generator and the STFT
loss of ``benchmark/reference/models.py`` and ``train.py``.

It imports nothing of the program. Submodule names are the program's
(``discriminators.i.convs.j``, ``discriminators.i.conv_post``), so one
state_dict serves both; ``set_precision`` of ``models.py`` rounds the
inputs and weights of every convolution here too.

Departures from arXiv:2010.05646, all as AERO's training code has them:

- the MPD's widths are hidden x (1, 4, 16, 32) with hidden 32, and the MSD's
  hidden is the configuration's (AERO's yaml: 64; HiFi-GAN V1: 128);
- the waveform is reflect-padded at its end to a multiple of the period
  (the paper does not say how), and each later MSD scale is fed
  ``avg_pool1d(4, 2, padding=2)`` counting the padding;
- the spectral norm takes ONE power iteration from the stored ``u`` on
  every call, train or eval. The order of storing ``u`` is the program's:
  the real forward that the generator and the discriminator share stores
  nothing, the generator's fake forward reads u0, and the discriminator's
  pass stores u1 = iter(u0) before its fake forward, which stores
  iter(u1);
- the mel loss is the L1 of power mel spectrograms (torchaudio's
  ``MelSpectrogram`` defaults: power 2, HTK mel scale, no filterbank
  norm), not of log-mel ones, weighted 45;
- the feature loss is the mean L1 over every feature map of a
  discriminator divided by the number of maps, added unweighted for each
  of the MSD and the MPD (the paper: weight 2, summed);
- the generator's loss adds the multi-resolution STFT loss of AERO;
- both gradients come from one state, then Adam on each network, as
  ``ReferenceStep`` does.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import models as R
from benchmark.reference.train import stft_loss

LRELU_SLOPE = 0.1


class WNConv2d(R._Quantised):
    """Weight-normalised conv2d: w = v * g / ||v||, the norm per output
    channel over (in, kh, kw)."""

    def __init__(self, chin, chout, kernel_size, stride, padding):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight_v = nn.Parameter(torch.empty(chout, chin, *kernel_size))
        self.weight_g = nn.Parameter(torch.ones(chout, 1, 1, 1))
        self.bias = nn.Parameter(torch.zeros(chout))

    def forward(self, x):
        v = self.weight_v
        norm = v.pow(2).sum(dim=(1, 2, 3), keepdim=True).sqrt()
        w = v * (self.weight_g / norm.clamp_min(1e-12))
        return F.conv2d(self.q(x), self.q(w), self.bias, self.stride,
                        self.padding)


class SNConv1d(R._Quantised):
    """Spectral-normalised conv1d: w / sigma, sigma = u'^T W v from one
    power iteration on W = weight_orig [out, in * k] from the stored u:
    v = normalize(W^T u), u' = normalize(W v), both constants of the
    gradient. ``store`` keeps u' in ``weight_u``."""

    def __init__(self, chin, chout, kernel_size, stride=1, padding=0,
                 groups=1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight_orig = nn.Parameter(
            torch.empty(chout, chin // groups, kernel_size))
        self.bias = nn.Parameter(torch.zeros(chout))
        self.register_buffer("weight_u", torch.ones(chout))

    def _matrix(self):
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    @torch.no_grad()
    def power_iteration(self):
        w = self._matrix()
        v = F.normalize(w.t() @ self.weight_u, dim=0, eps=1e-12)
        return F.normalize(w @ v, dim=0, eps=1e-12), v

    @torch.no_grad()
    def step_u(self):
        self.weight_u.copy_(self.power_iteration()[0])

    def forward(self, x, store: bool = False):
        u, v = self.power_iteration()
        if store:
            with torch.no_grad():
                self.weight_u.copy_(u)
        sigma = torch.dot(u, self._matrix() @ v)
        return F.conv1d(self.q(x), self.q(self.weight_orig / sigma),
                        self.bias, self.stride, self.padding, 1, self.groups)


class DiscriminatorP(nn.Module):
    """One period p: [B, 1, T] reflect-padded at its end to a multiple of
    p, folded to [B, 1, T / p, p], (5, 1) convs of widths hidden x (1, 4,
    16, 32) at stride (3, 1), one more at stride 1, then ``conv_post``;
    leaky ReLU 0.1 after every conv but the last. Returns (logits [B, -1],
    the feature maps, the logits' map last)."""

    def __init__(self, period: int, hidden: int):
        super().__init__()
        self.period = period
        widths = [1, hidden, hidden * 4, hidden * 16, hidden * 32]
        self.convs = nn.ModuleList(
            [WNConv2d(cin, cout, (5, 1), (3, 1), (2, 0))
             for cin, cout in zip(widths, widths[1:])]
            + [WNConv2d(hidden * 32, hidden * 32, (5, 1), (1, 1), (2, 0))])
        self.conv_post = WNConv2d(hidden * 32, 1, (3, 1), (1, 1), (1, 0))

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


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, hidden: int, periods: tp.Sequence[int]):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorP(p, hidden) for p in periods)

    def discriminate(self, x):
        """([logits per period], [feature maps per period])."""
        outs = [d(x) for d in self.discriminators]
        return [y for y, _ in outs], [f for _, f in outs]


class DiscriminatorS(nn.Module):
    """One scale: seven grouped convs (k 15, then k 41 at strides 2, 2, 4,
    4, 1, then k 5) and ``conv_post``, all spectral-normed or all
    weight-normed, leaky ReLU 0.1 after every conv but the last."""

    def __init__(self, spectral: bool, hidden: int):
        super().__init__()
        hd = hidden
        specs = [(1, hd, 15, 1, 7, 1), (hd, hd, 41, 2, 20, 4),
                 (hd, hd * 2, 41, 2, 20, 16), (hd * 2, hd * 4, 41, 4, 20, 16),
                 (hd * 4, hd * 8, 41, 4, 20, 16),
                 (hd * 8, hd * 8, 41, 1, 20, 16), (hd * 8, hd * 8, 5, 1, 2, 1)]
        conv = SNConv1d if spectral else R.WNConv1d
        self.spectral = spectral
        self.convs = nn.ModuleList(conv(cin, cout, k, s, p, groups=g)
                                   for cin, cout, k, s, p, g in specs)
        self.conv_post = conv(hd * 8, 1, 3, 1, 1)

    def forward(self, x, store: bool = False):
        kw = dict(store=store) if self.spectral else {}
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x, **kw), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x, **kw)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiScaleDiscriminator(nn.Module):
    """``num_D`` scales, the first spectral-normed; scale i > 0 takes
    ``avg_pool1d(4, 2, padding=2)`` of scale i - 1's input."""

    def __init__(self, hidden: int, num_D: int):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(i == 0, hidden) for i in range(num_D))

    def discriminate(self, x, store: bool = False):
        """([logits per scale], [feature maps per scale]); ``store``: the
        spectral-normed convs keep their new u."""
        logits, fmaps = [], []
        for i, d in enumerate(self.discriminators):
            if i:
                x = F.avg_pool1d(x, 4, 2, 2)
            y, fmap = d(x, store)
            logits.append(y)
            fmaps.append(fmap)
        return logits, fmaps

    def step_u(self):
        """Store one power iteration in every spectral-normed conv."""
        for m in self.modules():
            if isinstance(m, SNConv1d):
                m.step_u()


def build_reference(cfg, device, quant=R.exact) -> tp.Dict[str, nn.Module]:
    """{"generator": Aero, "msd_hifi": MSD, "mpd": MPD} of a configuration
    whose ``discriminator_models`` is ``["hifi"]``, on ``device``, with
    PyTorch's default initial values (``benchmark.weights_hifi`` draws the
    benchmark's)."""
    exp = cfg["experiment"]
    if list(exp["discriminator_models"]) != ["hifi"]:
        raise ValueError("reference: only the HiFi discriminators")
    with torch.device(device):
        models = {"generator": R.Aero(exp["aero"]),
                  "msd_hifi": MultiScaleDiscriminator(**exp["msd"]),
                  "mpd": MultiPeriodDiscriminator(**exp["mpd"])}
    for m in models.values():
        R.set_precision(m, quant)
    return models


# --- losses ------------------------------------------------------------------

def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, device
                   ) -> torch.Tensor:
    """[n_fft // 2 + 1, n_mels] triangular filters on the HTK mel scale,
    mel(f) = 2595 log10(1 + f / 700), from 0 Hz to the Nyquist rate,
    unnormalised; computed in float64, returned in float32."""
    def mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    freqs = torch.linspace(0, sample_rate // 2, n_fft // 2 + 1,
                           dtype=torch.float64)
    m_pts = torch.linspace(mel(0.0), mel(sample_rate / 2.0), n_mels + 2,
                           dtype=torch.float64)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = torch.clamp(torch.minimum(down, up), min=0.0)
    return fb.to(device=device, dtype=torch.float32)


def mel_spectrogram(x, sample_rate, n_fft, hop_length, win_length, n_mels):
    """[..., T] -> [..., n_mels, frames]: the power of a centred,
    reflect-padded STFT (Hann window of ``win_length``) through the
    filterbank."""
    z = R.stft(x, n_fft, hop_length, win_length, normalized=False)
    power = z.real ** 2 + z.imag ** 2
    fb = mel_filterbank(sample_rate, n_fft, n_mels, x.device)
    return torch.einsum("...ft,fm->...mt", power, fb)


def feature_loss(fmap_r, fmap_g):
    """Mean L1 over every feature map of every sub-discriminator, over the
    number of maps."""
    pairs = [(r, g) for dr, dg in zip(fmap_r, fmap_g)
             for r, g in zip(dr, dg)]
    return sum(torch.mean(torch.abs(r - g)) for r, g in pairs) / len(pairs)


def discriminator_loss(real, fake):
    """LS-GAN: mean((1 - real)^2) + mean(fake^2), summed over the
    sub-discriminators."""
    return sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2)
               for r, g in zip(real, fake))


def generator_loss(fake):
    """LS-GAN: mean((1 - fake)^2), summed over the sub-discriminators."""
    return sum(torch.mean((1 - g) ** 2) for g in fake)


def _detached(fmaps):
    return [[f.detach() for f in fmap] for fmap in fmaps]


class ReferenceHifiStep:
    """``step(lr, hr) -> {"total": generator loss, "discriminator": loss}``
    on float32 tensors [B, 1, T]. Parameters in the program's order: the
    generator's; the MSD's, then the MPD's. ``us`` are the stored u of the
    spectral-normed convs, state the step moves besides the weights."""

    def __init__(self, cfg, models, adam: bool = True):
        self.cfg = cfg
        self.gen = models["generator"]
        self.msd, self.mpd = models["msd_hifi"], models["mpd"]
        self.gen_params = list(self.gen.parameters())
        self.disc_params = (list(self.msd.parameters())
                            + list(self.mpd.parameters()))
        self.us = [m.weight_u for m in self.msd.modules()
                   if isinstance(m, SNConv1d)]
        if adam:
            kw = dict(lr=float(cfg["lr"]), betas=(0.9, float(cfg["beta2"])),
                      eps=1e-8, foreach=False, fused=False)
            self.gen_opt = torch.optim.Adam(self.gen_params, **kw)
            self.disc_opt = torch.optim.Adam(self.disc_params, **kw)

    def _mel_l1(self, pr, hr):
        exp = self.cfg["experiment"]
        kw = dict(exp["mel_spectrogram"], sample_rate=int(exp["hr_sr"]))
        return torch.mean(torch.abs(mel_spectrogram(hr, **kw)
                                    - mel_spectrogram(pr, **kw)))

    def _generator_loss(self, lr, hr):
        exp = self.cfg["experiment"]
        self.gen.train()
        pr = self.gen(lr)
        real = (self.msd.discriminate(hr), self.mpd.discriminate(hr))
        (ys_g, fs_g), (yp_g, fp_g) = (self.msd.discriminate(pr),
                                      self.mpd.discriminate(pr))
        total = stft_loss(pr[:, 0, :], hr[:, 0, :],
                          float(self.cfg["stft_sc_factor"]),
                          float(self.cfg["stft_mag_factor"]))
        fm = (feature_loss(_detached(real[0][1]), fs_g)
              + feature_loss(_detached(real[1][1]), fp_g))
        total = (total + generator_loss(ys_g) + generator_loss(yp_g) + fm
                 + float(exp["mel_spec_loss_lambda"]) * self._mel_l1(pr, hr))
        return pr, real, total

    def _discriminator_loss(self, pr_sg, real):
        """From the stored u0: u1 = iter(u0) stored, then the fake forward
        from it, storing iter(u1)."""
        self.msd.step_u()
        ys_g, _ = self.msd.discriminate(pr_sg, store=True)
        yp_g, _ = self.mpd.discriminate(pr_sg)
        return (discriminator_loss(real[0][0], ys_g)
                + discriminator_loss(real[1][0], yp_g))

    def grads(self, lr, hr):
        pr, real, total = self._generator_loss(lr, hr)
        gen_grads = torch.autograd.grad(total, self.gen_params,
                                        allow_unused=True)
        disc_loss = self._discriminator_loss(pr.detach(), real)
        disc_grads = torch.autograd.grad(disc_loss, self.disc_params,
                                         allow_unused=True)
        return gen_grads, disc_grads, {"total": total.detach(),
                                       "discriminator": disc_loss.detach()}

    @torch.no_grad()
    def losses(self, lr, hr):
        """The step's losses at the present weights and u, changing
        neither."""
        u0 = [u.clone() for u in self.us]
        pr, real, total = self._generator_loss(lr, hr)
        disc_loss = self._discriminator_loss(pr, real)
        for u, v in zip(self.us, u0):
            u.copy_(v)
        return {"total": float(total), "discriminator": float(disc_loss)}

    @staticmethod
    def _update(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def __call__(self, lr, hr):
        gen_grads, disc_grads, losses = self.grads(lr, hr)
        self._update(self.gen_opt, self.gen_params, gen_grads)
        self._update(self.disc_opt, self.disc_params, disc_grads)
        return {k: float(v) for k, v in losses.items()}
