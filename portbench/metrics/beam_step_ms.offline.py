"""One step of the beam search's loop (decode/beam.py, the beam.step span,
its finished-check sync included) in the traced offline job, ms."""

from portbench import spans


def value(record):
    return spans.mean_ms(record, "beam.step")
