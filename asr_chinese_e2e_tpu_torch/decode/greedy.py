"""Greedy decoding, in torch: CTC best path and autoregressive attention
decode (``asr_chinese_e2e_tpu/decode/greedy.py``).

- ``ctc_greedy_decode``: argmax over frames, collapse repeats, strip
  blanks; the finalisation on the host returns ragged id lists;
- ``attention_greedy_decode``: autoregressive argmax with the KV-cached
  ``decode_step``, a host loop of ``max_len`` steps (the JAX package's
  ``lax.scan``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..data.vocab import BLANK_ID, BOS_ID, EOS_ID
from .beam import _SPECIAL_SUPPRESS


def ctc_greedy_decode(log_probs: torch.Tensor, logit_lengths) -> List[List[int]]:
    """(B, T, C) log-probs -> per-utterance collapsed id sequences (the
    first maximal index wins a tie, as ``jnp.argmax``)."""
    ids = log_probs.argmax(dim=-1).cpu().numpy()  # (B, T)
    lengths = torch.as_tensor(logit_lengths).cpu().numpy()
    out: List[List[int]] = []
    for row, n in zip(ids, lengths):
        row = row[:n]
        keep = np.concatenate([[True], row[1:] != row[:-1]])  # collapse repeats
        collapsed = row[keep]
        out.append(collapsed[collapsed != BLANK_ID].tolist())
    return out


@torch.inference_mode()
def attention_greedy_decode(model, enc_out, enc_lengths, max_len: int):
    """Autoregressive argmax decode with the cached step path. Returns
    (tokens (B, max_len) int64, EOS-terminated with EOS after it; scores
    (B,) summed log-probs). PAD/blank, UNK and BOS are never emitted."""
    bsz, dev = enc_out.shape[0], enc_out.device
    state = model.init_decode_state(enc_out, enc_lengths, max_len + 1)
    tokens = torch.zeros((bsz, max_len + 1), dtype=torch.int64, device=dev)
    tokens[:, 0] = BOS_ID
    score = torch.zeros((bsz,), dtype=torch.float32, device=dev)
    finished = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    for i in range(max_len):
        logp, state = model.decode_step(tokens[:, i], state, i)
        logp = logp.clone()
        logp[:, :_SPECIAL_SUPPRESS] = -1e9
        nxt = logp.argmax(dim=-1)
        step_lp = logp.gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(finished, torch.full_like(nxt, EOS_ID), nxt)
        score = score + torch.where(finished, torch.zeros_like(step_lp), step_lp)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == EOS_ID)
    return tokens[:, 1:], score


def tokens_to_ids(tokens) -> List[List[int]]:
    """Truncate fixed-shape decode output at the first EOS (rows exclude
    the initial BOS position already)."""
    out = []
    for row in torch.as_tensor(tokens).cpu().numpy():
        ids = []
        for t in row:
            if t == EOS_ID:
                break
            ids.append(int(t))
        out.append(ids)
    return out
