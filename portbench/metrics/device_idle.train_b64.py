"""Of the cells that train in batches of 64 clips (``train_audio_s_per_s.b64``):
the device's idle share of the traced train steps' window (no kernel, copy
or set running), %."""

from portbench import readers


def value(record):
    return readers.idle_share(record)
