"""Host syncs (sync.* spans) a traced recognize request: a count, the same
every request and every seed."""

from portbench import spans


def value(record):
    return spans.syncs_per(record, "recognize")
