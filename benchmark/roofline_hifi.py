"""The work of one multi-period discriminator forward at a configuration's
shapes, the least time the card needs for it, and the device time a traced
run puts down to one of the program's spans (what the HiFi cell's
per-layer metrics read).

One forward of ``batch`` rows of ``samples``: per period p, the waveform
folded to [B, 1, ceil(T / p), p] and five (5, 1) convolutions and
``conv_post`` (``benchmark/reference/hifi.py``). FLOPs: 2 * output
elements * C_in * 5 (or 3) per convolution. Bytes, each read or written
once: the waveform in float32, every weight-normed convolution's ``v``,
``g`` and bias in float32, and every feature map the forward returns in
bfloat16 (the leaky ReLU's outputs and the logits; a fused kernel would
write nothing else). The bound is the larger of FLOPs over the bf16 dense
peak and bytes over the HBM bandwidth (``benchmark/roofline.py``).
"""

from __future__ import annotations

import typing as tp

from benchmark.roofline import PEAK_BYTES, PEAK_FLOPS


def _out_rows(rows: int, k: int, stride: int, pad: int) -> int:
    return (rows + 2 * pad - k) // stride + 1


def mpd_work(cfg, batch: int, samples: int) -> tp.Tuple[int, int]:
    """(FLOPs, bytes) of one MPD forward of ``batch`` rows of
    ``samples``."""
    mpd = cfg["experiment"]["mpd"]
    hidden = int(mpd["hidden"])
    widths = [1, hidden, hidden * 4, hidden * 16, hidden * 32]
    # (C_in, C_out, kernel, stride, padding) of each convolution
    layers = ([(cin, cout, 5, 3, 2) for cin, cout in zip(widths, widths[1:])]
              + [(hidden * 32, hidden * 32, 5, 1, 2),
                 (hidden * 32, 1, 3, 1, 1)])
    fl = 0
    by = 4 * batch * samples
    for p in mpd["periods"]:
        rows = -(-samples // int(p))
        for cin, cout, k, s, pad in layers:
            rows = _out_rows(rows, k, s, pad)
            out = batch * cout * rows * int(p)
            fl += 2 * out * cin * k
            by += 4 * (cout * cin * k + 2 * cout) + 2 * out
    return fl, by


def mpd_bound_s(cfg, batch: int, samples: int) -> float:
    """Least seconds the card needs for one MPD forward."""
    fl, by = mpd_work(cfg, batch, samples)
    return max(fl / PEAK_FLOPS, by / PEAK_BYTES)


def span_device(trace, span: str) -> tp.Optional[tp.Tuple[float, int]]:
    """(device seconds, count) of the program's span ``span`` in a traced
    run (``trace["program"]``, ``profiling.attribute``'s table); None where
    the run has no attribution or the program opens no such span."""
    program = trace.get("program") or {}
    seconds = program.get("device_s", {}).get(span)
    if not seconds:
        return None
    return seconds, program.get("spans", {}).get(span, {}).get("count", 0)
