"""Plain decoding: the encoder over one clip padded as the program pads it,
teacher-forced scores of token sequences, the attention beam search and the
CTC prefix beam search with attention rescoring, written from their
definitions (no cache: every step runs the decoder over the whole prefix).

Attention beam (``beam``): K hypotheses from [BOS]; each step scores every
(hypothesis, token) by its total log-probability, with the ids PAD, UNK and
BOS never emitted; a hypothesis that emitted EOS is finished and keeps its
score (only EOS at no cost); the K best of all K x V candidates go on, ties
to the lower index; at most ``max_len`` steps; the best by raw score.

CTC prefix beam (``rescore``): per frame t < length, every beam keeps its
prefix (blank, or a repeat of its last token without a blank) or extends it
by one of the frame's top ``prune`` classes other than blank (a repeat of
the last token only from the blank-ending mass), prefixes no longer than
``max_prefix_len``; equal prefixes add their masses; the K best prefixes by
log(p_blank + p_nonblank) go on, in float32 as the search runs. The n-best
is rescored by ctc_weight x CTC score + (1 - ctc_weight) x the decoder's
log-probability of prefix + EOS; the best wins, the first of equals."""

from __future__ import annotations

import numpy as np
import torch

from .features import features
from .model import BOS, EOS, Model, targets

SUPPRESS = BOS + 1  # ids below this are never emitted by the attention beam
NEG = -1e9


def encode_clips(model: Model, waves, feat: dict, boundaries):
    """Encode int16 clips (1-d tensors) each padded with zeros to the
    smallest of ``boundaries`` (samples) that holds it, as the program's
    bucketing pads them; returns [(enc (T', d), T')]."""
    out = []
    for w in waves:
        n = int(w.numel())
        b = next(x for x in boundaries if n <= x)
        padded = torch.zeros((1, b), dtype=torch.int16, device=w.device)
        padded[0, :n] = w
        feats, lens = features(padded, torch.tensor([n], device=w.device), feat)
        enc, elen = model.encode(feats, lens)
        out.append((enc[0, : int(elen[0])], int(elen[0])))
    return out


def sequence_logprobs(model: Model, enc, ids_list):
    """Per-position log-probs (B, L+1, V) of [BOS] + ids against ids + [EOS]
    for the sequences ``ids_list`` over one encoder output ``enc`` (T', d)."""
    lens = torch.tensor([len(x) for x in ids_list], device=enc.device)
    l = max(1, int(lens.max()))
    labels = torch.zeros((len(ids_list), l), dtype=torch.int64, device=enc.device)
    for i, ids in enumerate(ids_list):
        labels[i, : len(ids)] = torch.tensor(ids, dtype=torch.int64)
    ys_in, gold = targets(labels, lens)
    e = enc[None].expand(len(ids_list), -1, -1)
    elen = torch.full((len(ids_list),), enc.shape[0], device=enc.device)
    logits = model.decode(ys_in, lens + 1, e, elen)
    return torch.log_softmax(logits.float(), dim=-1), gold, lens


def beam_score(model: Model, enc, ids, finished: bool) -> float:
    """The attention beam's score of a served hypothesis: its tokens'
    log-probabilities, and EOS's where it finished."""
    logp, gold, _ = sequence_logprobs(model, enc, [ids])
    n = len(ids) + (1 if finished else 0)
    return float(logp[0, torch.arange(n), gold[0, :n]].sum())


def attention_beam(model: Model, enc, beam: int, max_len: int):
    """(best ids, finished, score) of the attention beam over one clip."""
    dev = enc.device
    hyps = [[BOS]]
    scores = torch.tensor([0.0], device=dev, dtype=torch.float64)
    done = [False]
    for _ in range(max_len):
        if all(done):
            break
        ys = torch.tensor(hyps, dtype=torch.int64, device=dev)
        n, t = ys.shape
        e = enc[None].expand(n, -1, -1)
        logits = model.decode(ys, torch.full((n,), t, device=dev), e,
                              torch.full((n,), enc.shape[0], device=dev))
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).double()
        logp[:, :SUPPRESS] = NEG
        for i in range(n):
            if done[i]:
                logp[i] = NEG
                logp[i, EOS] = 0.0
        cand = (scores[:, None] + logp).reshape(-1)
        order = torch.sort(cand, descending=True, stable=True).indices[:beam].tolist()
        v = logp.shape[1]
        new_hyps, new_scores, new_done = [], [], []
        for idx in order:
            parent, tok = divmod(idx, v)
            new_hyps.append(hyps[parent] + [tok])
            new_scores.append(float(cand[idx]))
            new_done.append(done[parent] or tok == EOS)
        hyps, done = new_hyps, new_done
        scores = torch.tensor(new_scores, device=dev, dtype=torch.float64)
    best = int(torch.argmax(scores))
    ids = []
    for tok in hyps[best][1:]:
        if tok == EOS:
            break
        ids.append(tok)
    return ids, done[best], float(scores[best])


BIG_NEG = np.float32(-1e30)


def _masked_lse(mask: np.ndarray, x: np.ndarray) -> np.ndarray:
    """log sum_j exp(x[..., j]) over the j where ``mask`` (float32)."""
    c = np.where(mask, x, BIG_NEG).astype(np.float32)
    m = c.max(axis=-1, keepdims=True)
    with np.errstate(over="ignore", invalid="ignore"):
        s = m[..., 0] + np.log(np.exp(c - m).sum(axis=-1, dtype=np.float32))
    return np.where(np.isfinite(s), s, BIG_NEG).astype(np.float32)


def _top(x: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest, equal values in ascending index order."""
    return np.argsort(-x, kind="stable")[:k]


def _merge(prefixes, plen, pb, pnb):
    """Fold the mass of equal live prefixes into their first occurrence."""
    k, l = prefixes.shape
    valid = np.arange(l)[None, None, :] < plen[:, None, None]
    same = np.all((prefixes[:, None, :] == prefixes[None, :, :]) | ~valid, axis=-1)
    live = np.logaddexp(pb, pnb) > BIG_NEG / 2
    eq = (plen[:, None] == plen[None, :]) & same & live[:, None] & live[None, :]
    eq |= np.eye(k, dtype=bool)
    rep = np.argmax(eq, axis=0)
    fold = rep[None, :] == np.arange(k)[:, None]
    is_rep = rep == np.arange(k)
    return (np.where(is_rep, _masked_lse(fold, pb[None, :]), BIG_NEG).astype(np.float32),
            np.where(is_rep, _masked_lse(fold, pnb[None, :]), BIG_NEG).astype(np.float32))


def ctc_prefix_beam(logp: torch.Tensor, beam: int, prune: int, max_prefix_len: int):
    """[(prefix, score)] best-first over the (T, V) log-probs of one clip,
    in float32 as the search runs. Per frame: merge equal prefixes; the
    frame's top ``prune`` classes (blank excluded) extend each prefix that
    is not full; each prefix also stays (blank, or its last token again);
    an extension that recreates a live prefix adds its mass to that
    prefix's stay, whatever the prune; the K best of stays and extensions go
    on, a prefix's stay before its extensions, ties to the earlier."""
    lp = logp.float().cpu().numpy()
    k, l = beam, max_prefix_len
    p = min(prune, lp.shape[1])
    prefixes = np.zeros((k, l), np.int64)
    plen = np.zeros(k, np.int64)
    last = np.full(k, -1, np.int64)
    pb = np.full(k, BIG_NEG, np.float32)
    pb[0] = 0.0
    pnb = np.full(k, BIG_NEG, np.float32)
    pos = np.arange(l)
    for t in range(lp.shape[0]):
        pb, pnb = _merge(prefixes, plen, pb, pnb)
        frame = lp[t]
        top_idx = _top(frame, p)
        top_val = np.where(top_idx == 0, BIG_NEG, frame[top_idx]).astype(np.float32)
        p_last = np.where(last < 0, BIG_NEG, frame[np.maximum(last, 0)]).astype(np.float32)
        p_any = np.logaddexp(pb, pnb)
        stay_pb = p_any + frame[0]
        stay_pnb = pnb + p_last
        repeat = top_idx[None, :] == last[:, None]
        ext = np.where(repeat, pb[:, None], p_any[:, None]) + top_val[None, :]
        ext = np.where((plen >= l)[:, None], BIG_NEG, ext).astype(np.float32)
        live = p_any > BIG_NEG / 2
        within = pos[None, None, :] < plen[None, :, None]
        same = np.all((prefixes[:, None, :] == prefixes[None, :, :]) | ~within, axis=-1)
        parent = ((plen[:, None] == plen[None, :] + 1) & same & (plen[:, None] > 0)
                  & live[:, None] & live[None, :])  # [i, j]: j is i's parent
        base = np.where(last[None, :] == last[:, None], pb[None, :], p_any[None, :])
        stay_pnb = np.logaddexp(stay_pnb, _masked_lse(parent, base + p_last[:, None]))
        stay = np.logaddexp(stay_pb, stay_pnb)
        kill = np.any(parent[:, :, None] & (top_idx[None, None, :] == last[:, None, None]),
                      axis=0)
        ext = np.where(kill, BIG_NEG, ext).astype(np.float32)
        all_pnb = np.concatenate([stay_pnb[:, None], ext], axis=1).reshape(-1)
        all_score = np.concatenate([stay[:, None], ext], axis=1).reshape(-1)
        sel = _top(all_score, k)
        src, slot = sel // (p + 1), sel % (p + 1)
        is_ext = slot > 0
        tok = top_idx[np.maximum(slot - 1, 0)]
        prefixes = prefixes[src].copy()
        new_len = plen[src]
        write = (pos[None, :] == np.minimum(new_len, l - 1)[:, None]) & is_ext[:, None]
        prefixes = np.where(write, tok[:, None], prefixes)
        plen = np.where(is_ext, new_len + 1, new_len)
        last = np.where(is_ext, tok, last[src])
        pb = np.where(is_ext, BIG_NEG, stay_pb[src]).astype(np.float32)
        pnb = np.where(is_ext, all_pnb[sel], stay_pnb[src]).astype(np.float32)
    pb, pnb = _merge(prefixes, plen, pb, pnb)
    scores = np.logaddexp(pb, pnb)
    out, seen = [], set()
    for i in np.argsort(-scores, kind="stable"):
        prefix = tuple(int(x) for x in prefixes[i, : plen[i]])
        if prefix not in seen:  # a dead copy of a merged prefix
            seen.add(prefix)
            out.append((prefix, float(scores[i])))
    return out


def rescore_scores(model: Model, enc, nbest, ctc_weight: float):
    """[(prefix, ctc score, attention score, total)] of an n-best list."""
    logp, gold, lens = sequence_logprobs(model, enc, [list(p) for p, _ in nbest])
    tok = logp.gather(2, gold[..., None])[..., 0]
    mask = (gold != 0).double()
    att = (tok.double() * mask).sum(1).tolist()
    return [(p, c, a, ctc_weight * c + (1.0 - ctc_weight) * a)
            for (p, c), a in zip(nbest, att)]

