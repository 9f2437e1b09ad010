"""Losses: label-smoothed cross-entropy and CTC, plus the hybrid joint
(``asr_chinese_e2e_tpu/losses.py``).

CE follows the reference (``Predictor/Utils/loss.py:7-76``): with
smoothing 0 the mean CE over non-PAD targets; with smoothing eps the
target ``one_hot*(1-eps) + (1-one_hot)*eps/C`` (eps/C, not eps/(C-1)),
summed against log-softmax and averaged over non-PAD positions. CTC is
``ops/ctc_kernel.py::ctc_loss_kernel`` (``ctc_impl="pallas"``, K3/K4) or
the autograd recursion of ``ops/ctc.py`` (any other value).

Under data parallelism each rank holds some rows of the global batch;
``model_loss(..., totals=...)`` then normalises over the global counts
(utterances for CTC, non-PAD targets for CE), so the ranks' losses and
gradients sum to the global batch's.
"""

from __future__ import annotations

import torch

from .data.vocab import IGNORE_ID
from .ops.ctc import ctc_loss
from .ops.ctc_kernel import ctc_loss_kernel


def smoothed_cross_entropy(logits, targets, smoothing: float = 0.0, n_word=None):
    """logits: (B, T, C) pre-softmax; targets: (B, T) with PAD == 0
    ignored. Returns (scalar loss, n_correct). ``n_word``: the count to
    divide by (default: these targets' non-PAD count)."""
    b, t, c = logits.shape
    logits = logits.reshape(b * t, c)
    gold = targets.reshape(b * t)
    mask = (gold != IGNORE_ID).to(logits.dtype)
    if n_word is None:
        n_word = mask.sum()
    n_word = n_word.clamp(min=1.0)
    log_probs = torch.log_softmax(logits, dim=-1)
    gold_safe = torch.where(gold == IGNORE_ID, torch.zeros_like(gold), gold).long()
    nll = -log_probs.gather(1, gold_safe[:, None])[:, 0]
    if smoothing > 0.0:
        eps = smoothing
        # one_hot*(1-eps - eps/C) + eps/C everywhere, against -log_probs
        sum_lp = log_probs.sum(dim=-1)
        per_pos = (1.0 - eps - eps / c) * nll - (eps / c) * sum_lp
        loss = (per_pos * mask).sum() / n_word
    else:
        loss = (nll * mask).sum() / n_word
    pred = logits.argmax(dim=-1)
    n_correct = ((pred == gold) & (gold != IGNORE_ID)).sum()
    return loss, n_correct


def model_loss(out: dict, labels, label_lengths, ctc_weight: float,
               smoothing: float, ctc_impl: str = "pallas", totals=None):
    """Hybrid lambda*CTC + (1-lambda)*CE over the branches the model gives
    (``out``: the forward dict). Returns (loss, metrics); metrics hold
    tensors (no host sync). ``totals`` (n_utt, n_word): the global batch's
    counts to normalise by, where these rows are one rank's part of it."""
    metrics = {}
    loss = 0.0
    has_ce = "logits" in out and ctc_weight < 1.0
    has_ctc = "ctc_logits" in out and ctc_weight > 0.0
    n_utt = n_word = None
    if totals is not None:
        n_utt, n_word = totals
    if has_ce:
        ce, n_correct = smoothed_cross_entropy(out["logits"], out["gold"], smoothing,
                                               n_word)
        n_word = (out["gold"] != IGNORE_ID).sum().float()
        metrics.update(ce_loss=ce, n_correct=n_correct, n_word=n_word)
        loss = loss + (1.0 - ctc_weight) * ce if has_ctc else ce
    if has_ctc:
        ctc_fn = ctc_loss_kernel if ctc_impl == "pallas" else ctc_loss
        per_utt = ctc_fn(out["ctc_logits"], out["enc_lengths"], labels, label_lengths)
        ctc = per_utt.mean() if n_utt is None else per_utt.sum() / n_utt
        metrics["ctc_loss"] = ctc
        loss = loss + ctc_weight * ctc if has_ce else ctc
    metrics["loss"] = loss
    return loss, metrics


def hybrid_loss(ce_logits, ce_targets, ctc_logits=None, ctc_logit_lengths=None,
                ctc_labels=None, ctc_label_lengths=None, ctc_weight: float = 0.0,
                smoothing: float = 0.0):
    """Tensor-argument convenience wrapper over ``model_loss`` (CTC by the
    autograd recursion, as the JAX package's wrapper uses its scan)."""
    out = {"logits": ce_logits, "gold": ce_targets}
    if ctc_logits is not None:
        out["ctc_logits"] = ctc_logits
        out["enc_lengths"] = ctc_logit_lengths
    return model_loss(out, ctc_labels, ctc_label_lengths, ctc_weight, smoothing, "scan")
