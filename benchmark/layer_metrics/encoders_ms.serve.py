"""Device ms of the four encoder layers (HEncLayer) per generator forward, from
CUDA events around each."""

from __future__ import annotations

import statistics

NAME = "encoders_ms.serve"
UNIT = "ms"


def modules(gen):
    """The modules whose device time this metric sums per forward."""
    return list(gen.encoder)


def read(trace):
    per_forward = trace["spans"].get(NAME) or []
    return statistics.fmean(per_forward) if per_forward else None
