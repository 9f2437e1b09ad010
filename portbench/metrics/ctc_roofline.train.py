"""K3 + K4 (ops/ctc_kernel.py) in the traced train steps: their least time by
the frozen CTC bounds over their device time in the profiler, %."""

from portbench import readers


def value(record):
    return readers.ctc_roofline(record)
