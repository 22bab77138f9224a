"""Build the port's generators (Aero, Seanet) and discriminators (MelGAN,
HiFi MSD and MPD) from an experiment config (port of
``aero_tpu/models/factory.py`` and ``aero_tpu/train/build.py:32-66``)."""

from __future__ import annotations

import typing as tp

import torch

from aero_tpu_torch.models.aero import Aero
from aero_tpu_torch.models.discriminators import (
    MelganDiscriminator, MultiPeriodDiscriminator, MultiScaleDiscriminator)
from aero_tpu_torch.models.init import init_aero_, init_normed_convs_
from aero_tpu_torch.models.seanet import Seanet

# The ``aero:`` block of conf/experiment/aero_4-16_512_64.yaml, resolved.
CANONICAL_AERO_4_16 = dict(
    in_channels=1, out_channels=1, channels=48, growth=2, nfft=512,
    hop_length=64, end_iters=0, cac=True, rewrite=True, hybrid=False,
    hybrid_old=False, freq_emb=0.2, emb_scale=10, emb_smooth=True,
    kernel_size=8, strides=[4, 4, 2, 2], context=1, context_enc=0,
    freq_ends=4, enc_freq_attn=0, norm_starts=2, norm_groups=4,
    dconv_mode=1, dconv_depth=2, dconv_comp=4, dconv_time_attn=2,
    dconv_lstm=2, dconv_init=1e-3, rescale=0.1, lr_sr=4000, hr_sr=16000,
    spec_upsample=True, act_func="snake", debug=False,
)

PRECISIONS = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DISCRIMINATOR_NAMES = ("msd_melgan", "msd_hifi", "mpd", "hifi")


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"got {precision!r}")
    return PRECISIONS[precision]


def build_generator(kwargs: tp.Mapping[str, tp.Any],
                    precision: str = "float32", device="cuda",
                    seed: int = 0, model: str = "aero") -> torch.nn.Module:
    """The ``model`` generator ("aero" or "seanet", from its config block
    ``kwargs``) in eval mode on ``device``, computing in ``precision``,
    with float32 weights from the seeded init (drawn on the CPU, then
    moved)."""
    kw = dict(kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    if model == "aero":
        kw["strides"] = tuple(kw.get("strides", (4, 4, 2, 2)))
        net = init_aero_(Aero(**kw, compute_dtype=_dtype(precision)), gen,
                         float(kw.get("rescale", 0) or 0))
    elif model == "seanet":
        kw["ratios"] = tuple(kw.get("ratios", (8, 8, 2, 2)))
        net = init_normed_convs_(
            Seanet(**kw, compute_dtype=_dtype(precision)), gen)
    else:
        raise ValueError(f"unknown generator model: {model!r}")
    return net.to(device).eval()


def build_discriminators(exp, precision: str = "float32", device="cuda",
                         seed: int = 0) -> tp.Dict[str, torch.nn.Module]:
    """The discriminators an adversarial experiment config names
    (``discriminator_models``), seeded, on ``device``, in the JAX
    factory's order; {} without ``adversarial``. ``hifi`` names no model
    of its own: it builds both ``msd_hifi`` (from ``exp.msd``) and
    ``mpd`` (from ``exp.mpd``)."""
    if not exp.get("adversarial", False):
        return {}
    names = list(exp.get("discriminator_models", []))
    unknown = [n for n in names if n not in DISCRIMINATOR_NAMES]
    if unknown:
        raise ValueError(f"unknown discriminator models {unknown}")
    cd = dict(compute_dtype=_dtype(precision))
    models = {}
    if "msd_melgan" in names:
        models["msd_melgan"] = init_normed_convs_(
            MelganDiscriminator(**dict(exp.melgan_discriminator), **cd),
            torch.Generator().manual_seed(int(seed)))
    if "msd_hifi" in names or "hifi" in names:
        models["msd_hifi"] = init_normed_convs_(
            MultiScaleDiscriminator(**dict(exp.msd), **cd),
            torch.Generator().manual_seed(int(seed) + 1))
    if "mpd" in names or "hifi" in names:
        models["mpd"] = init_normed_convs_(
            MultiPeriodDiscriminator(**dict(exp.mpd), **cd),
            torch.Generator().manual_seed(int(seed) + 2))
    return {name: m.to(device) for name, m in models.items()}
