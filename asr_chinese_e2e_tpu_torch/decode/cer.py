"""Character error rate — exact metric parity with the reference.

``calculate_cer`` matches ``Predictor/Utils/score.py:4-13``:
Levenshtein distance between space-joined char strings, normalised by the
reference's space-split token count. ``batch_cer_from_ids`` reproduces the
teacher-forced argmax CER of ``cal_metrics``
(``transformer_official.py:83-94``): argmax ids -> PAD-stripped space-joined
strings -> mean CER × 100 — but run on host at EVAL cadence only, not every
train step (SURVEY §3.2 flags the per-step device→host sync as a
throughput bug).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

try:
    import Levenshtein as _Lev

    def _distance(a: str, b: str) -> int:
        return _Lev.distance(a, b)

except ImportError:  # pure-python fallback

    def _distance(a: str, b: str) -> int:
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a, 1):
            cur = [i]
            for j, cb in enumerate(b, 1):
                cur.append(
                    min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
                )
            prev = cur
        return prev[-1]


def calculate_cer(hyp: str, ref: str) -> float:
    """Edit distance over space-joined chars / ref token count
    (``score.py:4-13``)."""
    word_num = len(ref.split(" "))
    return _distance(hyp, ref) / word_num


def _truncate_at_eos(ids: list, eos_id: int) -> list:
    """Everything before the first EOS (exclusive)."""
    if eos_id in ids:
        return ids[: ids.index(eos_id)]
    return ids


def batch_cer_from_ids(
    pred_ids: np.ndarray, gold_ids: np.ndarray, vocab, eos_id: int = 3
) -> float:
    """Teacher-forced argmax CER ×100 (``transformer_official.py:87-94``).

    Deliberate fix vs the reference metric: the reference argmaxes over ALL
    padded positions, so post-EOS garbage counts as insertions against the
    PAD-stripped ref — at flagship shapes that reads 117-140% "CER" while
    decoded CER is 1-3% (round-3 soak). Both hyp and ref are truncated at
    their first EOS before the Levenshtein, making the TF metric track the
    decoded-CER direction (SURVEY Appendix A convention: reference bugs are
    fixed, not replicated)."""
    cers = []
    for hyp_row, ref_row in zip(np.asarray(pred_ids), np.asarray(gold_ids)):
        ref = vocab.ids_to_str(_truncate_at_eos(ref_row.tolist(), eos_id))
        if not ref:
            continue
        hyp = vocab.ids_to_str(_truncate_at_eos(hyp_row.tolist(), eos_id))
        cers.append(calculate_cer(hyp, ref))
    return float(np.mean(cers) * 100.0) if cers else 0.0


def corpus_cer(hyps: Sequence[str], refs: Sequence[str]) -> float:
    """Decoded-text CER ×100: per-utterance char CER averaged (same
    normalisation as the metric path, applied to beam/greedy output)."""
    cers = []
    for hyp, ref in zip(hyps, refs):
        ref_s = " ".join(ref)
        hyp_s = " ".join(hyp)
        if ref_s:
            cers.append(calculate_cer(hyp_s, ref_s))
    return float(np.mean(cers) * 100.0) if cers else 0.0
