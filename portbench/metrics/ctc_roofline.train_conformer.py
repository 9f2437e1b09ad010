"""K3 + K4 (ops/ctc_kernel.py) in the traced conformer train steps: their least
time by the frozen CTC bounds, at the frames the conv2d frontend leaves, over
their device time in the profiler, %; read only when the launch counters saw
one K3 and one K4 a step."""

from portbench import readers_conformer


def value(record):
    return readers_conformer.ctc_roofline(record)
