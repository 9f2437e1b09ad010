"""The whole online decode's share of the H100's dense bf16 peak: the
benchmark's matmul count of the requests' work (encoder, CTC head, rescoring
forward), over the window, %."""

from portbench import readers


def value(record):
    return readers.decode_mfu(record)
