"""recognize's main thread waiting on the prefetch queue for its next batch
(wav reads and row padding; the recognize.next_batch span) a batch, ms."""

from portbench import spans


def value(record):
    return spans.total_ms_per(record, "recognize.next_batch", "recognize.dispatch")
