"""Share of the bf16 dense peak: the frozen FLOP count of the files completed
in the untraced part of a traced run over its seconds."""

from __future__ import annotations

from benchmark.roofline import PEAK_FLOPS

UNIT = "%"


def read(trace):
    if trace["flops"] <= 0 or trace["flops_s"] <= 0:
        return None
    return 100.0 * trace["flops"] / trace["flops_s"] / PEAK_FLOPS
