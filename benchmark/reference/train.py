"""Plain PyTorch reference of the GAN train step: the generator forward in
train mode (BatchNorm on batch statistics), the multi-resolution STFT loss,
the MelGAN hinge and feature losses, both gradients from one state, then
Adam on each network with betas (0.9, beta2), eps 1e-8 (the program's step
takes beta1 = 0.9 whatever the configuration's ``beta1`` says), and the
BatchNorms' running statistics moved towards the batch's."""

from __future__ import annotations

import typing as tp

import torch
import torch.nn.functional as F

from benchmark.reference.models import stft

STFT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def segment_lengths(cfg) -> tp.Tuple[int, int]:
    """(lr, hr) samples of one training segment."""
    exp = cfg["experiment"]
    lr_t = int(float(exp["segment"]) * exp["lr_sr"])
    return lr_t, lr_t * (exp["hr_sr"] // exp["lr_sr"])


def stft_magnitude(x, fft_size, hop, win_length):
    z = stft(x, fft_size, hop, win_length, normalized=False)
    return torch.sqrt(torch.clamp_min(z.real ** 2 + z.imag ** 2, 1e-7))


def stft_loss(x, y, factor_sc, factor_mag):
    """Spectral convergence and log-magnitude L1 over the three
    resolutions, each the mean over resolutions times its factor."""
    sc = mag = 0.0
    for fs, hop, wl in STFT_RESOLUTIONS:
        x_mag = stft_magnitude(x, fs, hop, wl)
        y_mag = stft_magnitude(y, fs, hop, wl)
        sc = sc + torch.sqrt(torch.sum((y_mag - x_mag) ** 2)) / torch.sqrt(
            torch.sum(y_mag ** 2))
        mag = mag + torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    n = len(STFT_RESOLUTIONS)
    return factor_sc * sc / n + factor_mag * mag / n


def melgan_generator_losses(fake, real, n_layers, num_d):
    weight = (4.0 / (n_layers + 1)) * (1.0 / num_d)
    feat = 0.0
    for i in range(num_d):
        for j in range(len(fake[i]) - 1):
            feat = feat + weight * torch.mean(torch.abs(
                fake[i][j] - real[i][j].detach()))
    adv = 0.0
    for scale in fake:
        adv = adv + torch.mean(F.relu(1 - scale[-1]))
    return adv, feat


def melgan_discriminator_loss(fake, real):
    loss = 0.0
    for scale in fake:
        loss = loss + torch.mean(F.relu(1 + scale[-1]))
    for scale in real:
        loss = loss + torch.mean(F.relu(1 - scale[-1]))
    return loss


class ReferenceStep:
    """``step(lr, hr) -> {"total": generator loss, "discriminator": loss}``
    on float32 tensors [B, 1, T]."""

    def __init__(self, cfg, models, adam: bool = True):
        self.cfg = cfg
        self.gen, self.disc = models["generator"], models["msd_melgan"]
        self.gen_params = list(self.gen.parameters())
        self.disc_params = list(self.disc.parameters())
        if adam:
            kw = dict(lr=float(cfg["lr"]), betas=(0.9, float(cfg["beta2"])),
                      eps=1e-8, foreach=False, fused=False)
            self.gen_opt = torch.optim.Adam(self.gen_params, **kw)
            self.disc_opt = torch.optim.Adam(self.disc_params, **kw)

    def _generator_loss(self, lr, hr):
        exp = self.cfg["experiment"]
        mel = exp["melgan_discriminator"]
        self.gen.train()
        pr = self.gen(lr)
        real = self.disc(hr)
        total = stft_loss(pr[:, 0, :], hr[:, 0, :],
                          float(self.cfg["stft_sc_factor"]),
                          float(self.cfg["stft_mag_factor"]))
        adv, feat = melgan_generator_losses(self.disc(pr), real,
                                            int(mel["n_layers"]),
                                            int(mel["num_D"]))
        total = total + adv + float(exp["features_loss_lambda"]) * feat
        return pr, real, total

    def grads(self, lr, hr):
        pr, real, total = self._generator_loss(lr, hr)
        gen_grads = torch.autograd.grad(total, self.gen_params,
                                        allow_unused=True)
        disc_loss = melgan_discriminator_loss(self.disc(pr.detach()), real)
        disc_grads = torch.autograd.grad(disc_loss, self.disc_params,
                                         allow_unused=True)
        return gen_grads, disc_grads, {"total": total.detach(),
                                       "discriminator": disc_loss.detach()}

    @torch.no_grad()
    def losses(self, lr, hr):
        """The step's losses at the present weights, with no update."""
        pr, real, total = self._generator_loss(lr, hr)
        disc_loss = melgan_discriminator_loss(self.disc(pr), real)
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
