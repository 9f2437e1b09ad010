"""Host syncs (sync.* spans) a traced train step of 64 clips: a count, the
same every step and every seed."""

from portbench import spans


def value(record):
    return spans.syncs_per(record, "train_step")
