"""The device's idle share of the traced offline job's window, %."""

from portbench import readers


def value(record):
    return readers.idle_share(record)
