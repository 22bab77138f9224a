"""The frozen FLOP count of the HiFi configuration's train step: the
conventions of ``benchmark/flops.py`` applied to ``ReferenceHifiStep``'s
gradients on the ``meta`` device. The MPD's and MSD's convolutions count
by the convolution rule (grouped where they are grouped), the mel
spectrograms' STFTs as DFT products, the filterbank as a product; the
power iterations' matrix-vector products count too (a few MFLOPs)."""

from __future__ import annotations

import torch

from benchmark import flops


def train_flops(cfg, batch: int) -> int:
    """One GAN train step of ``batch`` segments against the HiFi
    discriminators."""
    from benchmark.reference.hifi import ReferenceHifiStep, build_reference
    from benchmark.reference.train import segment_lengths

    step = ReferenceHifiStep(cfg, build_reference(cfg, "meta"), adam=False)
    lr_t, hr_t = segment_lengths(cfg)
    lr = torch.empty(batch, 1, lr_t, device="meta")
    hr = torch.empty(batch, 1, hr_t, device="meta")
    return flops.count(step.grads, lr, hr)
