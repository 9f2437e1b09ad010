"""Host syncs (sync.* spans) a traced conformer train step: a count."""

from portbench import spans


def value(record):
    return spans.syncs_per(record, "train_step")
