"""The device's idle share of the traced requests' window, %."""

from portbench import readers


def value(record):
    return readers.idle_share(record)
