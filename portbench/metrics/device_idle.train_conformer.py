"""The device's idle share of the traced conformer train steps' window (no
kernel, copy or set running), %."""

from portbench import readers


def value(record):
    return readers.idle_share(record)
