"""Roofline share of the multi-period discriminator's forwards in training:
the least time the card needs for one MPD forward at the cell's shapes
(``benchmark/roofline_hifi.py``), times the forwards profiled (the count of
the program's span ``hifi.mpd``), over the device time put down to that
span. Nothing where the program opens no such span."""

from __future__ import annotations

from benchmark.reference.train import segment_lengths
from benchmark.roofline_hifi import mpd_bound_s, span_device

UNIT = "%"
SPAN = "hifi.mpd"


def read(trace):
    found = span_device(trace, SPAN)
    if found is None or not found[1]:
        return None
    seconds, forwards = found
    _, hr_t = segment_lengths(trace["cfg"])
    bound = forwards * mpd_bound_s(trace["cfg"], trace["batch"], hr_t)
    return 100.0 * bound / seconds
