"""The n-best's trip to the host (the copy and the Python loop of
device_nbest_to_lists, the rescore.nbest_to_host span) a traced request, ms."""

from portbench import spans


def value(record):
    return spans.total_ms_per(record, "rescore.nbest_to_host", "recognize")
