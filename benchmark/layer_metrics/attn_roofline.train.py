"""Roofline share of the LocalState attention kernels in training, forward and
backward: the least time the card needs for the profiled steps' attention,
at the configuration's shapes, over the kernels' device time."""

from __future__ import annotations

import re

from benchmark.reference.train import segment_lengths
from benchmark.roofline import attention_bound_s

UNIT = "%"
# the forward and the two backward kernels of ops/attention.py
KERNELS = re.compile(r"local_attention_(fwd|bwd)")


def read(trace):
    seconds = sum(s for name, s in trace["kernels"] if KERNELS.search(name))
    if seconds <= 0:
        return None
    lr_t, _ = segment_lengths(trace["cfg"])
    bound = trace["steps"] * attention_bound_s(trace["cfg"], trace["batch"],
                                               lr_t, backward=True)
    return 100.0 * bound / seconds
