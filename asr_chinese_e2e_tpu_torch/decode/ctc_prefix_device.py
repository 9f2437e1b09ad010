"""CTC prefix beam search on dense tensors, in torch
(``asr_chinese_e2e_tpu/decode/ctc_prefix_device.py``).

The exact host search (``decode/ctc_prefix.py``) keeps a dict of prefixes;
this version keeps the beam as tensors on the encoder's device:

- state: prefixes (B, K, L), lengths (B, K), last tokens (B, K), and the
  per-prefix (log p ending in blank, ending in non-blank) pair (B, K);
- one step per frame: per-frame vocabulary pruning to P candidates, a
  (B, K·(P+1)) candidate score matrix (the +1 is the "stay" candidate:
  blank or repeat of the last token), global top-K, batched gathers to
  reorder the state; on the card the whole loop is one call of K9
  (``ops/ctc_prefix_beam_kernel.py``), on the CPU its plain version
  ``ctc_prefix_beam_reference``, a host loop over T with no host sync;
- variable lengths by freezing the carry past each utterance's length.

Duplicate prefixes (one string reached from two parent beams) are merged at
every step: a K×K prefix-equality matrix folds their (pb, pnb) mass into
the first occurrence by a masked log-sum-exp and kills the copies, as the
host search's dict does. Top-k keeps ``lax.top_k``'s tie order (a stable
descending sort).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.vocab import BLANK_ID
from ..ops.ctc import BIG_NEG
from ..ops.ctc_prefix_beam_kernel import ctc_prefix_beam_kernel
from ..utils.debug import annotate
from .beam import _top_k_stable


def _masked_logsumexp(mask, x):
    """log Σ_j exp(x[..., j]) over the j where ``mask``; BIG_NEG if none."""
    contrib = torch.where(mask, x, BIG_NEG)
    m = contrib.max(dim=2, keepdim=True).values
    s = m[..., 0] + torch.log(torch.exp(contrib - m).sum(dim=2))
    return torch.where(torch.isfinite(s), s, BIG_NEG)


def _prefix_equal(prefixes, within):
    """(B, i, j): the tokens of prefixes i and j agree at every position
    where ``within`` (B, 1|K, 1|K, L) holds."""
    tok_eq = prefixes[:, :, None, :] == prefixes[:, None, :, :]
    return torch.all(tok_eq | ~within, dim=-1)


def _merge_duplicates(prefixes, plen, last, pb, pnb):
    """Fold the probability mass of duplicate prefixes into their first
    occurrence; duplicates are killed to BIG_NEG so top-k reuses their
    slots."""
    bsz, k, l = prefixes.shape
    dev = prefixes.device
    same_len = plen[:, :, None] == plen[:, None, :]
    valid = torch.arange(l, device=dev)[None, None, None, :] < plen[:, :, None, None]
    eq = same_len & _prefix_equal(prefixes, valid)  # (B, K, K)
    live = torch.logaddexp(pb, pnb) > BIG_NEG / 2
    eq = eq & live[:, :, None] & live[:, None, :]
    eq = eq | torch.eye(k, dtype=torch.bool, device=dev)[None]  # self always
    # first equal index i per column j (argmax takes the first maximum)
    rep = torch.argmax(eq.to(torch.int32), dim=1)  # (B, K)
    slots = torch.arange(k, device=dev)
    fold = rep[:, None, :] == slots[None, :, None]  # (B, K_i, K_j)
    pb2 = _masked_logsumexp(fold, pb[:, None, :])
    pnb2 = _masked_logsumexp(fold, pnb[:, None, :])
    is_rep = rep == slots[None, :]
    return (
        prefixes, plen, last,
        torch.where(is_rep, pb2, BIG_NEG), torch.where(is_rep, pnb2, BIG_NEG),
    )


def ctc_prefix_beam_reference(log_probs, logit_lengths, beam_size, prune, max_prefix_len):
    """Plain version of K9, the search on the CPU: the contract of
    ``ctc_prefix_beam_device``."""
    bsz, t_max, vocab = log_probs.shape
    k, p, l = beam_size, min(prune, vocab), max_prefix_len
    dev = log_probs.device
    log_probs = log_probs.float()
    lengths = torch.as_tensor(logit_lengths, device=dev)
    pos = torch.arange(l, device=dev)

    prefixes = torch.zeros((bsz, k, l), dtype=torch.int64, device=dev)
    plen = torch.zeros((bsz, k), dtype=torch.int64, device=dev)
    last = torch.full((bsz, k), -1, dtype=torch.int64, device=dev)  # -1: empty
    # only beam 0 live initially: (pb, pnb) = (log 1, log 0)
    pb = torch.full((bsz, k), BIG_NEG, dtype=torch.float32, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((bsz, k), BIG_NEG, dtype=torch.float32, device=dev)

    for t in range(t_max):
        prefixes, plen, last, pb, pnb = _merge_duplicates(prefixes, plen, last, pb, pnb)
        frame = log_probs[:, t]  # (B, C)
        p_blank = frame[:, BLANK_ID][:, None]
        top_vals, top_idx = _top_k_stable(frame, p)  # (B, P)
        # the blank is no extension (the "stay" candidate covers it)
        top_vals = torch.where(top_idx == BLANK_ID, BIG_NEG, top_vals)
        # p(last token of each beam) under this frame; empty: no repeat
        p_last = frame.gather(1, last.clamp(min=0))
        p_last = torch.where(last < 0, BIG_NEG, p_last)
        p_any = torch.logaddexp(pb, pnb)

        # ---- stay candidate (prefix unchanged) ----
        stay_pb = p_any + p_blank  # blank path
        stay_pnb = pnb + p_last  # repeat of last without blank

        # ---- extend candidates (append token c) ----
        cand_tok = top_idx[:, None, :].expand(-1, k, -1)  # (B, K, P)
        cand_lp = top_vals[:, None, :]
        # same token: only the post-blank path extends; different: both
        ext_pnb = torch.where(
            cand_tok == last[..., None], pb[..., None] + cand_lp, p_any[..., None] + cand_lp
        )
        ext_pnb = torch.where((plen >= l)[..., None], BIG_NEG, ext_pnb)  # full prefixes

        # ---- exact merge before select (host dict semantics) ----
        # an extend of beam j that recreates beam i's prefix (prefix_i ==
        # prefix_j + [last_i]) folds into beam i's stay candidate and
        # leaves the extend set
        live = p_any > BIG_NEG / 2
        within_j = pos[None, None, None, :] < plen[:, None, :, None]  # (B, 1, j, L)
        is_parent = (
            (plen[:, :, None] == plen[:, None, :] + 1)
            & _prefix_equal(prefixes, within_j)
            & (plen[:, :, None] > 0)
            & live[:, :, None]
            & live[:, None, :]
        )  # (B, i, j)
        base_j = torch.where(
            last[:, None, :] == last[:, :, None], pb[:, None, :], p_any[:, None, :]
        )  # (B, i, j)
        csum = _masked_logsumexp(is_parent, base_j + p_last[:, :, None])
        stay_pnb = torch.logaddexp(stay_pnb, csum)
        stay_score = torch.logaddexp(stay_pb, stay_pnb)
        ext_kill = torch.any(
            is_parent[:, :, :, None] & (cand_tok[:, None, :, :] == last[:, :, None, None]),
            dim=1,
        )  # (B, j, P)
        ext_pnb = torch.where(ext_kill, BIG_NEG, ext_pnb)

        # ---- global top-k over K·(P+1) candidates ----
        all_pnb = torch.cat([stay_pnb[..., None], ext_pnb], dim=2).reshape(bsz, k * (p + 1))
        all_scores = torch.cat([stay_score[..., None], ext_pnb], dim=2).reshape(
            bsz, k * (p + 1))
        _, sel_idx = _top_k_stable(all_scores, k)  # (B, K)
        parent = sel_idx // (p + 1)
        slot = sel_idx % (p + 1)  # 0 = stay, 1..P = extend with top_idx[slot-1]

        new_prefixes = prefixes.gather(1, parent[..., None].expand(-1, -1, l))
        new_plen = plen.gather(1, parent)
        new_last = last.gather(1, parent)
        is_ext = slot > 0
        tok = top_idx.gather(1, (slot - 1).clamp(min=0))  # (B, K)
        write = (pos[None, None, :] == new_plen.clamp(max=l - 1)[..., None]) & is_ext[..., None]
        new_prefixes = torch.where(write, tok[..., None], new_prefixes)
        new_plen = torch.where(is_ext, new_plen + 1, new_plen)
        new_last = torch.where(is_ext, tok, new_last)
        new_pb = torch.where(is_ext, BIG_NEG, stay_pb.gather(1, parent))
        new_pnb = torch.where(
            is_ext, all_pnb.gather(1, sel_idx), stay_pnb.gather(1, parent)
        )

        # freeze carries past each utterance's length
        active = (t < lengths)[:, None]
        prefixes = torch.where(active[..., None], new_prefixes, prefixes)
        plen = torch.where(active, new_plen, plen)
        last = torch.where(active, new_last, last)
        pb = torch.where(active, new_pb, pb)
        pnb = torch.where(active, new_pnb, pnb)

    prefixes, plen, last, pb, pnb = _merge_duplicates(prefixes, plen, last, pb, pnb)
    scores = torch.logaddexp(pb, pnb)
    order = torch.argsort(-scores, dim=1, stable=True)
    return (
        prefixes.gather(1, order[..., None].expand(-1, -1, l)),
        plen.gather(1, order),
        scores.gather(1, order),
    )


@torch.inference_mode()
def ctc_prefix_beam_device(
    log_probs: torch.Tensor,  # (B, T, C)
    logit_lengths: torch.Tensor,  # (B,)
    beam_size: int = 10,
    prune: int = 8,
    max_prefix_len: int = 64,
):
    """Returns (prefixes (B, K, L) int64, prefix_lengths (B, K), scores
    (B, K)) sorted best-first: the plain version on CPU tensors, K9 on CUDA
    tensors (the log-probs cast to f32 first, as the plain version does)."""
    dev = log_probs.device.type
    if dev == "cpu":
        return ctc_prefix_beam_reference(
            log_probs, logit_lengths, beam_size, prune, max_prefix_len)
    if dev == "cuda":
        return ctc_prefix_beam_kernel(
            log_probs.float(), logit_lengths, beam_size, prune, max_prefix_len)
    raise ValueError(f"ctc prefix beam: unsupported device {log_probs.device}")


def device_nbest_to_lists(prefixes, plen, scores) -> List[List[Tuple[Tuple[int, ...], float]]]:
    """Convert the device beam's output to the host n-best format of
    ``attention_rescore``."""
    with annotate("sync.rescore.nbest"):
        prefixes, plen, scores = (
            torch.as_tensor(x).cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (prefixes, plen, scores)
        )
    out = []
    for b in range(prefixes.shape[0]):
        hyps = []
        seen = set()
        for kk in range(prefixes.shape[1]):
            ids = tuple(int(x) for x in prefixes[b, kk, : plen[b, kk]])
            if ids in seen:  # unmerged duplicates: keep the best copy
                continue
            seen.add(ids)
            hyps.append((ids, float(scores[b, kk])))
        out.append(hyps)
    return out
