"""Roofline share of the LocalState attention forward kernels: the least time
the card needs for the attention of the profiled forwards, at the
configuration's shapes, over the kernels' device time."""

from __future__ import annotations

import re

from benchmark.roofline import attention_bound_s

UNIT = "%"
# the forward kernels of ops/attention.py (csrc/local_attention*.cu)
KERNELS = re.compile(r"local_attention_fwd")


def read(trace):
    seconds = sum(s for name, s in trace["kernels"] if KERNELS.search(name))
    if seconds <= 0:
        return None
    bound = sum(attention_bound_s(trace["cfg"], rows, n, backward=False)
                for rows, n in trace["forwards"])
    return 100.0 * bound / seconds
