"""MelGAN adversarial losses (port of ``aero_tpu/losses/adversarial.py:15-65``).

Each argument ``disc_*`` is the discriminator's output: one list of
feature maps per scale, the logits last. The hinge terms and the feature
L1 are taken in float32.
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
