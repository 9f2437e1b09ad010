"""The device's busy time (kernels, copies, sets) a traced request, from the
profiler's timeline, ms: the device's share of the work, steadier than the
host clock."""

from portbench import readers


def value(record):
    return readers.device_ms_per_unit(record)
