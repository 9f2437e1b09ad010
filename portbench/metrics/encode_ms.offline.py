"""Features and the encoder (K5, K1) a batch of the offline job: recognize's
timing encode_s over its batches, ms."""

from portbench import readers


def value(record):
    return readers.span_ms_per_batch(record, "encode_s")
