"""Host syncs (sync.* spans) inside the traced recognize call, its drains'
included, over its batches: a count."""

from portbench import spans


def value(record):
    return spans.syncs_per_batch(record)
