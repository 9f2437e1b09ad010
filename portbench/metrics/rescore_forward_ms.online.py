"""The rescoring forward (attention_rescore: the hypotheses' packing and
copy, the teacher-forced decoder, the scores' copy back; the rescore.forward
span) a traced request, ms."""

from portbench import spans


def value(record):
    return spans.total_ms_per(record, "rescore.forward", "recognize")
