"""The whole offline decode's share of the H100's dense bf16 peak: the
benchmark's matmul count of the calls' work (encoder, 40 beam steps of every
row), over the window, %."""

from portbench import readers


def value(record):
    return readers.decode_mfu(record)
