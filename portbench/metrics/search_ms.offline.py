"""The attention beam a batch of the offline job: recognize's timing search_s
(dispatch and drain) over its batches, ms."""

from portbench import readers


def value(record):
    return readers.span_ms_per_batch(record, "search_s")
