"""Of the cells that train in batches of 64 clips (``train_audio_s_per_s.b64``):
the device's busy time (kernels, copies, sets) a traced train step, from the
profiler's timeline, ms: the device's share of the work, steadier than the
host clock."""

from portbench import readers


def value(record):
    return readers.device_ms_per_unit(record)
