"""The host's own work a traced conformer train step: the train_step span
less its sync.* spans (the program's spans, utils/debug.py), ms."""

from portbench import spans


def value(record):
    return spans.step_dispatch_ms(record)
