"""The whole train step's share of the H100's dense bf16 peak: the frozen
analytic_train_flops of each window step at its padded shapes, summed, over
the window, %."""

from portbench import readers


def value(record):
    return readers.train_mfu(record)
