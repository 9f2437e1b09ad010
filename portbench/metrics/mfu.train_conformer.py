"""The conformer's whole train step's share of the H100's dense bf16 peak: the
frozen counts/conformer.py count of each window step at its padded shapes,
summed, over the window, %."""

from portbench import readers_conformer


def value(record):
    return readers_conformer.train_mfu(record)
