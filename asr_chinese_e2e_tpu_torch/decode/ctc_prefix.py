"""CTC prefix beam search + attention rescoring, in torch
(``asr_chinese_e2e_tpu/decode/ctc_prefix.py``).

- ``ctc_prefix_beam_search``: per-prefix (blank, non-blank) probability
  beam in log space (Hannun et al. 2014) on the host over the (T, C)
  posteriors; pure numpy, copied.
- ``attention_rescore``: the second pass: the CTC n-best is scored by the
  attention decoder teacher-forced in ONE batched ``decode_logits`` call;
  final score = λ·ctc + (1−λ)·attention.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..data.vocab import BLANK_ID
from ..models.transformer import preprocess_targets
from ..utils.debug import annotate

LOG_ZERO = -1e30


def _logaddexp(a: float, b: float) -> float:
    if a <= LOG_ZERO / 2:
        return b
    if b <= LOG_ZERO / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def ctc_prefix_beam_search(
    log_probs: np.ndarray,
    num_frames: int,
    beam_size: int = 10,
) -> List[Tuple[Tuple[int, ...], float]]:
    """(T, C) log posteriors -> [(prefix ids, log prob)] best-first."""
    lp = np.asarray(log_probs)
    # prefix -> (log p ending in blank, log p ending in non-blank)
    beams = {(): (0.0, LOG_ZERO)}
    for t in range(num_frames):
        frame = lp[t]
        # prune the frame's candidate tokens for speed
        cand = np.argpartition(-frame, min(beam_size * 2, len(frame) - 1))[
            : beam_size * 2
        ]
        nxt: dict = {}

        def acc(prefix, pb, pnb):
            old = nxt.get(prefix, (LOG_ZERO, LOG_ZERO))
            nxt[prefix] = (_logaddexp(old[0], pb), _logaddexp(old[1], pnb))

        for prefix, (pb, pnb) in beams.items():
            p_total = _logaddexp(pb, pnb)
            for s in cand:
                p = float(frame[s])
                if s == BLANK_ID:
                    acc(prefix, p_total + p, LOG_ZERO)
                elif prefix and s == prefix[-1]:
                    # repeat: extends non-blank of same prefix; new symbol
                    # only after a blank
                    acc(prefix, LOG_ZERO, pnb + p)
                    acc(prefix + (int(s),), LOG_ZERO, pb + p)
                else:
                    acc(prefix + (int(s),), LOG_ZERO, p_total + p)
        beams = dict(
            sorted(
                nxt.items(),
                key=lambda kv: -_logaddexp(kv[1][0], kv[1][1]),
            )[:beam_size]
        )
    out = [
        (prefix, _logaddexp(pb, pnb)) for prefix, (pb, pnb) in beams.items()
    ]
    out.sort(key=lambda x: -x[1])
    return out


def ctc_prefix_beam_batch(
    log_probs: np.ndarray,
    logit_lengths: np.ndarray,
    beam_size: int = 10,
) -> List[List[Tuple[Tuple[int, ...], float]]]:
    return [
        ctc_prefix_beam_search(log_probs[b], int(logit_lengths[b]), beam_size)
        for b in range(log_probs.shape[0])
    ]


@torch.inference_mode()
def _rescore_scores(model, labels, label_lengths, enc, enc_lens):
    """Teacher-forced log-prob of each padded hypothesis, summed over its
    non-PAD target positions: one ``decode_logits`` call."""
    ys_in, ys_out = preprocess_targets(labels, label_lengths)
    logits = model.decode_logits(ys_in, label_lengths + 1, enc, enc_lens)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_lp = logp.gather(2, ys_out[..., None])[..., 0]
    return (tok_lp * (ys_out != 0)).sum(dim=1)


def attention_rescore(
    model,
    enc_out: torch.Tensor,
    enc_lengths: torch.Tensor,
    nbest: Sequence[Sequence[Tuple[Tuple[int, ...], float]]],
    ctc_weight: float = 0.3,
) -> List[List[int]]:
    """Second-pass rescoring of per-utterance CTC n-best lists. All
    (utterance, hypothesis) pairs are scored in ONE batched teacher-forced
    decoder call; returns the best id sequence per utterance."""
    pairs = []  # (b, prefix, ctc_score)
    for b, hyps in enumerate(nbest):
        for prefix, score in hyps:
            pairs.append((b, prefix, score))
    if not pairs:
        return [[] for _ in range(enc_out.shape[0])]
    max_l = max(max(len(p) for _, p, _ in pairs), 1)
    n = len(pairs)
    labels = np.zeros((n, max_l), np.int64)
    label_lengths = np.zeros((n,), np.int64)
    for i, (_, prefix, _) in enumerate(pairs):
        labels[i, : len(prefix)] = prefix
        label_lengths[i] = len(prefix)
    dev = enc_out.device
    with annotate("sync.rescore.hyps_to_device"):  # pageable copies
        batch_idx = torch.as_tensor([b for b, _, _ in pairs], device=dev)
        labels_d = torch.from_numpy(labels).to(dev)
        label_lengths_d = torch.from_numpy(label_lengths).to(dev)
    att_scores = _rescore_scores(
        model, labels_d, label_lengths_d, enc_out[batch_idx], enc_lengths.to(dev)[batch_idx],
    )
    with annotate("sync.rescore.scores"):
        att_scores = att_scores.cpu().numpy()

    best: List[List[int]] = [[] for _ in range(enc_out.shape[0])]
    best_score = [-np.inf] * enc_out.shape[0]
    for i, (b, prefix, ctc_score) in enumerate(pairs):
        score = ctc_weight * ctc_score + (1.0 - ctc_weight) * float(att_scores[i])
        if score > best_score[b]:
            best_score[b] = score
            best[b] = list(prefix)
    return best
