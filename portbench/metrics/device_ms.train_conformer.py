"""The device's busy time (kernels, copies, sets) a traced conformer train
step, from the profiler's timeline, ms."""

from portbench import readers_conformer


def value(record):
    return readers_conformer.device_ms_per_step(record)
