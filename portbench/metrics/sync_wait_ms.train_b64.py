"""The host's time in syncs (sync.* spans: reads of card tensors and waits
for the card) a traced train step of 64 clips, ms."""

from portbench import spans


def value(record):
    return spans.sync_wait_ms(record)
