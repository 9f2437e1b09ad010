"""The CTC prefix beam's launch (K9, the rescore.prefix_beam span) a
traced request, ms of the host's clock."""

from portbench import spans


def value(record):
    return spans.total_ms_per(record, "rescore.prefix_beam", "recognize")
