"""Build the port's generator from an ``aero:`` config block
(port of ``aero_tpu/models/factory.py`` and ``aero_tpu/train/build.py:32-66``)."""

from __future__ import annotations

import typing as tp

import torch

from aero_tpu_torch.models.aero import Aero
from aero_tpu_torch.models.init import init_aero_

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


def build_generator(aero_kwargs: tp.Mapping[str, tp.Any],
                    precision: str = "float32", device="cpu",
                    seed: int = 0) -> Aero:
    """Aero in eval mode on ``device``, computing in ``precision``, with
    float32 weights from the seeded init (drawn on the CPU, then moved)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"got {precision!r}")
    kw = dict(aero_kwargs)
    kw["strides"] = tuple(kw.get("strides", (4, 4, 2, 2)))
    model = Aero(**kw, compute_dtype=PRECISIONS[precision])
    gen = torch.Generator().manual_seed(int(seed))
    init_aero_(model, gen, float(kw.get("rescale", 0) or 0))
    return model.to(device).eval()
