"""recognize.py's own host work a request (one batch): call wall less its
encode and search spans, ms."""

from portbench import readers


def value(record):
    return readers.host_ms_per_batch(record)
