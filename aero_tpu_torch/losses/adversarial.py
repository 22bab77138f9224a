"""Adversarial losses: MelGAN hinge and feature matching, HiFi-GAN LS-GAN
and feature matching (port of ``aero_tpu/losses/adversarial.py:15-126``,
the unmasked forms).

A MelGAN argument ``disc_*`` is the discriminator's output: one list of
feature maps per scale, the logits last. A HiFi argument is one entry per
sub-discriminator: its flattened logits or its list of feature maps. Every
term is taken in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def melgan_discriminator_loss(disc_fake, disc_real):
    """Hinge loss on each scale's logits: mean relu(1 + fake) + mean
    relu(1 - real)."""
    loss = 0.0
    for scale in disc_fake:
        loss = loss + torch.mean(F.relu(1 + scale[-1].float()))
    for scale in disc_real:
        loss = loss + torch.mean(F.relu(1 - scale[-1].float()))
    return loss


def melgan_generator_losses(disc_fake, disc_real, n_layers: int, num_d: int):
    """(adversarial, unweighted feature loss): mean relu(1 - fake logits)
    per scale, and the L1 between fake and detached real feature maps
    (every map but the logits) weighted by (4 / (n_layers + 1)) / num_d."""
    weight = (4.0 / (n_layers + 1)) * (1.0 / num_d)
    features_loss = 0.0
    for i in range(num_d):
        for j in range(len(disc_fake[i]) - 1):
            features_loss = features_loss + weight * torch.mean(torch.abs(
                disc_fake[i][j].float() - disc_real[i][j].detach().float()))
    adversarial_loss = 0.0
    for scale in disc_fake:
        adversarial_loss = adversarial_loss + torch.mean(
            F.relu(1 - scale[-1].float()))
    return adversarial_loss, features_loss


def hifi_feature_loss(fmap_r, fmap_g):
    """Mean L1 over every feature map of every sub-discriminator, divided
    by the number of maps (``adversarial.py:98-109``). Nothing is
    detached here: a caller that holds the real maps' graph detaches them."""
    loss, total = 0.0, 0
    for dr, dg in zip(fmap_r, fmap_g):
        for r, g in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(r.float() - g.float()))
            total += 1
    return loss / total


def hifi_discriminator_loss(disc_real_outputs, disc_generated_outputs):
    """LS-GAN: mean((1 - real)^2) + mean(fake^2) per sub-discriminator."""
    loss = 0.0
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        loss = loss + torch.mean((1 - dr.float()) ** 2) + torch.mean(
            dg.float() ** 2)
    return loss


def hifi_generator_loss(disc_outputs):
    """LS-GAN: mean((1 - fake)^2) per sub-discriminator."""
    loss = 0.0
    for dg in disc_outputs:
        loss = loss + torch.mean((1 - dg.float()) ** 2)
    return loss
