"""Peaks of the card, and the work of the LocalState attention kernels at a
configuration's shapes.

Two roofs bound a kernel: its operations at the bf16 dense tensor-core
peak, and its bytes at the HBM bandwidth (NVIDIA H100 SXM5 data sheet).
No third roof for the exponentials (the SFU's rate) is used: a kernel may
compute part of its exponentials on the FMA pipes, and then beats that
roof, so a share against it could read above 100% without any work
miscounted.
"""

from __future__ import annotations

import typing as tp

PEAK_FLOPS = 989.4e12   # bf16 dense, H100 SXM5
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM5
HEADS = 4               # LocalState's heads (the program's default)


def frames(cfg, lr_samples: int) -> int:
    """Analysis STFT frames of ``lr_samples`` input samples."""
    a = cfg["experiment"]["aero"]
    hop = int(a["hop_length"] // (a["hr_sr"] / a["lr_sr"]))
    return 1 + -(-lr_samples // hop)


def attention_calls(cfg, batch: int, lr_samples: int
                    ) -> tp.List[tp.Tuple[int, int, int, int]]:
    """(sequences, T, heads, head width) of every LocalState call of one
    generator forward of ``batch`` rows of ``lr_samples`` samples."""
    a = cfg["experiment"]["aero"]
    t = frames(cfg, lr_samples)
    calls = []
    chout, freqs = int(a["channels"]), int(a["nfft"]) // 2
    for index, stride in enumerate(a["strides"]):
        freqs //= stride
        if index >= a["dconv_time_attn"]:
            width = int(chout / a["dconv_comp"]) // HEADS
            calls += [(batch * freqs, t, HEADS, width)] * int(a["dconv_depth"])
        chout = int(a["growth"] * chout)
    return calls


def attention_bound_s(cfg, batch: int, lr_samples: int,
                      backward: bool) -> float:
    """Least seconds the card needs for the attention of one forward (and
    its backward): per call the larger of FLOPs over the FLOP peak and
    bytes over the bandwidth. Forward: q, k, v, out in bf16 and the decay
    in f32 (and the log-sum-exp it writes for a backward); FLOPs 4 n h t^2
    c. Backward: reads q, k, v, out, the output's gradient, the decay and
    the log-sum-exp, writes dq, dk, dv and the decay's gradient; FLOPs
    twice the forward's."""
    total = 0.0
    for n, t, h, c in attention_calls(cfg, batch, lr_samples):
        fwd_flops = 4 * n * h * t * t * c
        elems, rows = n * t * h * c, n * t * h
        fwd_bytes = 4 * 2 * elems + 4 * rows + (4 * rows if backward else 0)
        total += max(fwd_flops / PEAK_FLOPS, fwd_bytes / PEAK_BYTES)
        if backward:
            bwd_bytes = 5 * 2 * elems + 2 * 4 * rows + 3 * 2 * elems + 4 * rows
            total += max(2 * fwd_flops / PEAK_FLOPS, bwd_bytes / PEAK_BYTES)
    return total
