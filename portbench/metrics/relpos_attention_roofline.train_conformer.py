"""K11 + K12 (the rel-pos attention kernels, ops/csrc/relpos/) in the traced
conformer train steps: their least time by the frozen counts/conformer.py
bounds over their device time in the profiler, %; read only when the launch
counters saw one K11 and one K12 a block a step."""

from portbench import readers_conformer


def value(record):
    return readers_conformer.relpos_roofline(record)
