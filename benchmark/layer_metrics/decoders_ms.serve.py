"""Device ms of the four decoder layers (HDecLayer) per generator forward, from
CUDA events around each."""

from __future__ import annotations

import statistics

NAME = "decoders_ms.serve"
UNIT = "ms"


def modules(gen):
    """The modules whose device time this metric sums per forward."""
    return list(gen.decoder)


def read(trace):
    per_forward = trace["spans"].get(NAME) or []
    return statistics.fmean(per_forward) if per_forward else None
