"""The host's time in the conformer's frontend a traced train step: the
encoder.frontend spans (the 256-channel conv2d subsampler's forward, the
program's spans, utils/debug.py) summed over the train_step spans, ms."""

from portbench import spans


def value(record):
    return spans.total_ms_per(record, "encoder.frontend", "train_step")
