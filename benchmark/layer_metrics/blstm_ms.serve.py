"""Device ms of the BLSTM modules (cuDNN's float32 LSTM on the default path)
per generator forward, from CUDA events around each."""

from __future__ import annotations

import statistics

NAME = "blstm_ms.serve"
UNIT = "ms"


def modules(gen):
    """The modules whose device time this metric sums per forward."""
    return [m for m in gen.modules() if type(m).__name__ == "BLSTM"]


def read(trace):
    per_forward = trace["spans"].get(NAME) or []
    return statistics.fmean(per_forward) if per_forward else None
