"""The rescore search a request (K9, the n-best's trip to the host, the
rescoring forward): recognize's timing search_s over its batches, ms."""

from portbench import readers


def value(record):
    return readers.span_ms_per_batch(record, "search_s")
