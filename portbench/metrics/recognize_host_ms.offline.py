"""recognize.py's own host work a batch of the offline job (bucketing, wav
reads, row padding, n-best to text): call wall less its encode and search
spans, over the batches, ms."""

from portbench import readers


def value(record):
    return readers.host_ms_per_batch(record)
