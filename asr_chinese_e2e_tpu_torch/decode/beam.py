"""Batched beam search with KV cache, in torch.

Counterpart of ``asr_chinese_e2e_tpu/decode/beam.py``: beam state is dense
tensors (tokens (B, K, L+1), scores (B, K), finished (B, K)); one cached
decoder step per position over the flattened (B*K) rows; expansion and
pruning over (B, K*V); finished hypotheses may only emit EOS, at zero
cost; non-lexical ids are suppressed; GNMT length normalisation at the
final sort. The loop runs on the host and stops early once every
hypothesis has finished (a host sync a step, and another for the EOS
row's scalar write); each step is a ``beam.step`` span.

Ties break as in JAX (``lax.top_k`` and ``jnp.argsort`` take the lower
index first): selection uses a stable descending sort, because
``torch.topk`` promises no order among equal values, and equal values are
common among the NEG_INF-scored slots.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..data.vocab import BOS_ID, EOS_ID
from ..ops.masks import NEG_INF
from ..utils.debug import annotate

# ids [0, BOS_ID] (PAD/blank, UNK, BOS) are never valid emissions
_SPECIAL_SUPPRESS = BOS_ID + 1


@dataclasses.dataclass
class BeamResult:
    """n-best per utterance: tokens (B, K, L) (BOS stripped), scores (B,
    K), finished (B, K) — True if the hyp emitted EOS before max_len;
    sorted best-first. Fields may be device tensors until ``materialize``
    (called by ``nbest_ids``) copies them to host numpy."""

    tokens: np.ndarray
    scores: np.ndarray
    finished: np.ndarray

    def materialize(self) -> "BeamResult":
        if isinstance(self.tokens, torch.Tensor):
            with annotate("sync.beam.materialize"):
                self.tokens = self.tokens.cpu().numpy()
                self.scores = self.scores.cpu().numpy()
                self.finished = self.finished.cpu().numpy()
        return self

    def nbest_ids(self, nbest: int = 1) -> List[List[List[int]]]:
        self.materialize()
        out = []
        for b in range(self.tokens.shape[0]):
            hyps = []
            for k in range(min(nbest, self.tokens.shape[1])):
                ids = []
                for t in self.tokens[b, k]:
                    if t == EOS_ID:
                        break
                    ids.append(int(t))
                hyps.append(ids)
            out.append(hyps)
        return out


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples (an LSTM
    carry is a (c, h) tuple)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def init_decode_state(model, enc_out, enc_lengths, max_len, beam):
    """Decode state for ``beam`` hypotheses per utterance. Models flagging
    ``FOLD_BEAM_CROSS`` keep cross K/V at one row per utterance; others get
    the encoder tensors repeated to B*K rows."""
    if getattr(model, "FOLD_BEAM_CROSS", False):
        return model.init_decode_state(enc_out, enc_lengths, max_len, beam)
    return model.init_decode_state(
        enc_out.repeat_interleave(beam, dim=0),
        enc_lengths.repeat_interleave(beam, dim=0),
        max_len,
    )


def make_gather_carry(bsz: int, k: int):
    """Carry-reorder fn: gathers every (B*K)-leading tensor of the carry
    sub-tree by the (B, K) parent map. The static sub-tree must not go
    through this: it is beam-invariant."""

    def gather_carry(carry_state, parent):
        base = torch.arange(bsz, device=parent.device)[:, None] * k
        flat = (base + parent).reshape(bsz * k)

        def g(x):
            if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] == bsz * k:
                return x[flat]
            return x

        return _tree_map(g, carry_state)

    return gather_carry


def _top_k_stable(x: torch.Tensor, k: int):
    """Top-k along the last dim, equal values in ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_search(
    model,
    enc_out: torch.Tensor,
    enc_lengths: torch.Tensor,
    beam_size: int,
    max_len: int,
    length_penalty: float = 0.0,
    lazy: "str | bool" = "auto",
) -> BeamResult:
    """Batched attention beam search.

    ``length_penalty`` > 0 applies GNMT normalisation ((5 + len) / 6)^lp
    at the final sort; 0.0 sorts by raw score. ``lazy`` selects the cache
    reorder on beam reselection: True keeps the self-KV caches unpermuted
    and routes through a (B, K, L) ancestry map (``decode_step_lazy``);
    False gathers the carry sub-tree; "auto" uses lazy when the model has
    it. Both give the same beams."""
    if lazy == "auto":
        lazy = hasattr(model, "decode_step_lazy")
    bsz, k = enc_out.shape[0], beam_size
    dev = enc_out.device
    state = init_decode_state(model, enc_out, enc_lengths, max_len + 1, k)
    static = state["static"]
    carry_state = state["carry"]
    gather_carry = make_gather_carry(bsz, k)

    tokens = torch.zeros((bsz, k, max_len + 1), dtype=torch.int64, device=dev)
    tokens[:, :, 0] = BOS_ID
    # only beam slot 0 is live initially (all slots hold the same BOS)
    scores = torch.full((bsz, k), NEG_INF, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((bsz, k), dtype=torch.bool, device=dev)
    lengths = torch.zeros((bsz, k), dtype=torch.int64, device=dev)
    anc = torch.zeros((bsz, k, max_len + 1), dtype=torch.int64, device=dev)
    slots = torch.arange(k, device=dev)

    i = 0
    while i < max_len:
        with annotate("beam.step"):
            with annotate("sync.beam.finished"):
                done = bool(finished.all())
            if done:
                break
            last = tokens[:, :, i].reshape(bsz * k)
            st = {"carry": carry_state, "static": static}
            if lazy:
                anc[:, :, i] = slots[None]  # position i's KV is each slot's own
                logp, st = model.decode_step_lazy(last, st, i, anc)
            else:
                logp, st = model.decode_step(last, st, i)
            carry_state = st["carry"]
            v = logp.shape[-1]
            logp = logp.reshape(bsz, k, v).clone()
            logp[:, :, :_SPECIAL_SUPPRESS] = NEG_INF
            # finished hyps: only EOS allowed, at zero cost (score frozen)
            eos_row = torch.full((v,), NEG_INF, dtype=torch.float32, device=dev)
            with annotate("sync.beam.eos_row"):  # a host scalar's copy
                eos_row[EOS_ID] = 0.0
            logp = torch.where(finished[:, :, None], eos_row, logp)

            cand = scores[:, :, None] + logp  # (B, K, V)
            scores, top_idx = _top_k_stable(cand.reshape(bsz, k * v), k)
            parent = top_idx // v  # (B, K)
            token = top_idx % v

            if lazy:
                anc = anc.gather(1, parent[:, :, None].expand(-1, -1, anc.shape[2]))
            else:
                carry_state = gather_carry(carry_state, parent)
            tokens = tokens.gather(1, parent[:, :, None].expand(-1, -1, tokens.shape[2]))
            tokens[:, :, i + 1] = token
            was_finished = finished.gather(1, parent)
            lengths = lengths.gather(1, parent)
            lengths = torch.where(was_finished, lengths, lengths + 1)
            finished = was_finished | (token == EOS_ID)
        i += 1

    if length_penalty > 0.0:
        norm = ((5.0 + lengths.to(torch.float32)) / 6.0) ** length_penalty
        sort_scores = scores / norm
    else:
        sort_scores = scores
    order = torch.argsort(-sort_scores, dim=1, stable=True)
    scores = sort_scores.gather(1, order)
    tokens = tokens[:, :, 1:].gather(1, order[:, :, None].expand(-1, -1, max_len))
    finished = finished.gather(1, order)
    return BeamResult(tokens, scores, finished)
