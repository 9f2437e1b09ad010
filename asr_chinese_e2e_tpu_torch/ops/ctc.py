"""CTC loss as a log-space forward recursion over time, differentiated by
autograd (``asr_chinese_e2e_tpu/ops/ctc.py``, ``ctc_impl="scan"``).

Blank id 0 (shared with PAD, which never occurs inside a label sequence).
Log-zero is ``BIG_NEG = -1e30``, not ``-inf``: ``logaddexp`` of two
log-zeros stays finite, and so do the gradients. Variable logit and label
lengths are handled by masking the carry, so shapes stay static.
"""

from __future__ import annotations

import torch

BIG_NEG = -1e30  # safe -inf: exp underflows to 0, no NaN under autograd


def extend_labels(labels: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """(B, L) -> (B, 2L+1) blank-interleaved: [b, l1, b, l2, ..., b]."""
    b, l = labels.shape
    ext = torch.full((b, 2 * l + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def skip_mask(ext: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """(B, S) bool: the s-2 -> s transition is allowed where the symbol is
    not blank and differs from the symbol two back."""
    allow = (ext[:, 2:] != blank_id) & (ext[:, 2:] != ext[:, :-2])
    return torch.cat([torch.zeros_like(allow[:, :2]), allow], dim=1)


def shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """new[:, s] = x[:, s-k], filled with BIG_NEG."""
    return torch.cat([torch.full_like(x[:, :k], BIG_NEG), x[:, :-k]], dim=1)


def alpha_step(alpha, emit_t, can_skip, active):
    """One step of the alpha recursion over (B, S): stay, shift-1 and the
    ``can_skip``-gated shift-2 terms plus the emission, where ``active``
    (B, 1); elsewhere the carry is frozen."""
    stay = torch.logaddexp(alpha, shift_right(alpha, 1))
    with_skip = torch.where(can_skip, torch.logaddexp(stay, shift_right(alpha, 2)), stay)
    return torch.where(active, with_skip + emit_t, alpha)


def loss_from_alpha(alpha, label_lengths):
    """-log p from the final alpha (B, S): logaddexp of the last blank and
    the last label (log-zero for an empty label)."""
    last = (2 * label_lengths.to(alpha.device)).long()
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(last > 0, a_prev, torch.full_like(a_prev, BIG_NEG))
    return -torch.logaddexp(a_last, a_prev)


def ctc_loss(logits, logit_lengths, labels, label_lengths, blank_id: int = 0):
    """Per-utterance negative log-likelihood.

    logits: (B, T, C) pre-softmax; logit_lengths: (B,) valid frames;
    labels: (B, L) target ids (no blanks), 0-padded; label_lengths: (B,).
    Returns (B,) float32 losses."""
    t_max = logits.shape[1]
    dev = logits.device
    ext = extend_labels(labels.long(), blank_id)
    can_skip = skip_mask(ext, blank_id)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    emit = log_probs.gather(2, ext[:, None, :].expand(-1, t_max, -1))  # (B, T, S)
    logit_lengths = logit_lengths.to(dev)
    label_lengths = label_lengths.to(dev)

    big = torch.full_like(emit[:, 0], BIG_NEG)
    s_idx = torch.arange(ext.shape[1], device=dev)[None, :]
    alpha = torch.where(s_idx == 0, emit[:, 0], big)
    alpha = torch.where((s_idx == 1) & (label_lengths[:, None] > 0), emit[:, 0], alpha)
    for t in range(1, t_max):
        alpha = alpha_step(alpha, emit[:, t], can_skip, (t < logit_lengths)[:, None])
    return loss_from_alpha(alpha, label_lengths)
