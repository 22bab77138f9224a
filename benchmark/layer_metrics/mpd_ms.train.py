"""Device ms a train step of the multi-period discriminator's forwards (the
real one, the generator's fake one and the discriminator's fake one): the
device work launched inside the program's span ``hifi.mpd``
(``MultiPeriodDiscriminator.discriminate``), put down to it by
``profiling.attribute`` over the profiled steps. Their backward is not in
it (it runs under ``train.*_backward``). Nothing where the program opens
no such span."""

from __future__ import annotations

from benchmark.roofline_hifi import span_device

UNIT = "ms"
SPAN = "hifi.mpd"


def read(trace):
    found = span_device(trace, SPAN)
    if found is None or trace["steps"] <= 0:
        return None
    return 1e3 * found[0] / trace["steps"]
