"""Device ms a train step of the generator loss's mel L1 (both mel
spectrograms): the device work launched inside the program's span
``loss.mel``, put down to it by ``profiling.attribute`` over the profiled
steps. Its backward is not in it (it runs under ``train.gen_backward``).
Nothing where the program opens no such span."""

from __future__ import annotations

from benchmark.roofline_hifi import span_device

UNIT = "ms"
SPAN = "loss.mel"


def read(trace):
    found = span_device(trace, SPAN)
    if found is None or trace["steps"] <= 0:
        return None
    return 1e3 * found[0] / trace["steps"]
