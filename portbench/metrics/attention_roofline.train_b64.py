"""Of the cells that train in batches of 64 clips (``train_audio_s_per_s.b64``):
k1 + K2 (ops/fused_attention.py) in the traced train steps: their least time
by the frozen attention bounds over their device time in the profiler, %."""

from portbench import readers


def value(record):
    return readers.attention_roofline(record)
