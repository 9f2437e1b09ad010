"""One-pass joint CTC/attention beam search, in torch
(``asr_chinese_e2e_tpu/decode/joint.py``).

At every beam step the candidate score interpolates the attention decoder's
cumulative log-prob with the CTC prefix probability (Watanabe et al. 2017):
score = (1 - λ)·attention + λ·CTC-prefix. Beam state is dense tensors; the
loop over decode steps runs on the host with one host sync per step (the
early stop), as ``decode/beam.py``. Per step:

- the top ``ctc_prune`` attention candidates of each hypothesis (EOS forced
  into the last slot) are scored by ``_ctc_candidate_scores``: one
  (B, K, P, T) gather and one masked log-sum-exp over frames, no loop;
- the per-frame CTC registers of the K selected extensions come from
  ``ops/ctc_prefix_kernel.py::ctc_selected_registers``: kernel K8 on the
  card (one launch a step), its plain loop over frames on the CPU.

Recursion (log domain, ⊕ = logaddexp, xs = CTC log-probs, h = g·c):

    phi(t)    = r_b^g(t) ⊕ [c != last(g)] · r_nb^g(t)
    r_nb^h(t) = (r_nb^h(t-1) + xs(t, c)) ⊕ (phi(t-1) + xs(t, c))
    r_b^h(t)  = (r_b^h(t-1) ⊕ r_nb^h(t-1)) + xs(t, blank)
    psi       = ⊕_t phi(t-1) + xs(t, c)         (prefix probability)
    eos       = r_nb^g(T-1) ⊕ r_b^g(T-1)         (complete-sequence prob)

Ties break as in JAX (``lax.top_k``, ``jnp.argsort``): stable sorts.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.vocab import BLANK_ID, BOS_ID, EOS_ID
from ..ops.ctc_prefix_kernel import LOG_ZERO, ctc_selected_registers
from ..ops.masks import NEG_INF
from .beam import (
    _SPECIAL_SUPPRESS,
    BeamResult,
    _top_k_stable,
    init_decode_state,
    make_gather_carry,
)


def _lae(a, b):
    return torch.logaddexp(a, b)


def ctc_prefix_scores_host(
    xs: np.ndarray, prefix: list, cands: list, blank_id: int = BLANK_ID
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Reference CTC prefix scorer for ONE utterance (numpy, the oracle).

    xs: (T, C) log-probs; prefix: token ids of g; cands: candidate ids.
    Returns (psi (P,), r_nb (P, T), r_b (P, T), eos_score) for h = g·c; g's
    registers are recomputed from scratch, symbol by symbol."""
    t_max = xs.shape[0]

    def registers(g):
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.zeros(t_max)
        if not g:
            acc = 0.0
            for t in range(t_max):
                acc += xs[t, blank_id]
                r_b[t] = acc
            return r_nb, r_b
        pg_nb, pg_b = registers(g[:-1])
        c = g[-1]
        last_prev = g[-2] if len(g) > 1 else None
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.full(t_max, LOG_ZERO)
        for t in range(t_max):
            if t == 0:
                r_nb[0] = xs[0, c] if len(g) == 1 else LOG_ZERO
                r_b[0] = LOG_ZERO
                continue
            phi = pg_b[t - 1]
            if c != last_prev:
                phi = np.logaddexp(phi, pg_nb[t - 1])
            r_nb[t] = np.logaddexp(r_nb[t - 1], phi) + xs[t, c]
            r_b[t] = np.logaddexp(r_b[t - 1], r_nb[t - 1]) + xs[t, blank_id]
        return r_nb, r_b

    g_nb, g_b = registers(list(prefix))
    last = prefix[-1] if prefix else None
    p = len(cands)
    psi = np.full(p, LOG_ZERO)
    r_nb_out = np.full((p, t_max), LOG_ZERO)
    r_b_out = np.full((p, t_max), LOG_ZERO)
    for i, c in enumerate(cands):
        r_nb = np.full(t_max, LOG_ZERO)
        r_b = np.full(t_max, LOG_ZERO)
        if not prefix:
            r_nb[0] = xs[0, c]
            acc_psi = r_nb[0]
        else:
            acc_psi = LOG_ZERO
        for t in range(1, t_max):
            phi = g_b[t - 1]
            if last is None or c != last:
                phi = np.logaddexp(phi, g_nb[t - 1])
            r_nb[t] = np.logaddexp(r_nb[t - 1], phi) + xs[t, c]
            r_b[t] = np.logaddexp(r_b[t - 1], r_nb[t - 1]) + xs[t, blank_id]
            acc_psi = np.logaddexp(acc_psi, phi + xs[t, c])
        psi[i] = acc_psi
        r_nb_out[i] = r_nb
        r_b_out[i] = r_b
    eos_score = np.logaddexp(g_nb[t_max - 1], g_b[t_max - 1])
    return psi, r_nb_out, r_b_out, float(eos_score)


def _parent_eos_score(frame_mask, r_nb_g, r_b_g):
    """Complete-sequence score of each parent (the EOS candidate's CTC
    score): its registers at the last valid frame. (B, K)."""
    idx = frame_mask.sum(dim=1) - 1  # (B,)
    idx = idx[:, None, None].expand(-1, r_nb_g.shape[1], 1)
    return _lae(r_nb_g.gather(2, idx)[..., 0], r_b_g.gather(2, idx)[..., 0])


def _ctc_candidate_scores(ctc_lp_flat, frame_mask, r_nb_g, r_b_g, cand, last, is_empty):
    """CTC prefix scores of all K·P candidate extensions, no loop: psi
    depends only on the parent's registers, so it is one masked
    log-sum-exp over frames.

    ctc_lp_flat: (B·C, T) class-major log-probs; frame_mask: (B, T);
    r_nb_g / r_b_g: (B, K, T) parent registers; cand: (B, K, P) candidate
    ids; last: (B, K) last token of each parent (-1 if empty); is_empty:
    (B, K). Returns (psi (B, K, P), eos (B, K))."""
    b = frame_mask.shape[0]
    c = ctc_lp_flat.shape[0] // b
    rows = torch.arange(b, device=cand.device)[:, None, None] * c + cand
    xs = ctc_lp_flat[rows]  # (B, K, P, T)
    same = cand == last[:, :, None]
    phi = torch.where(
        same[..., None], r_b_g[:, :, None, :], _lae(r_b_g, r_nb_g)[:, :, None, :]
    )  # (B, K, P, T)
    psi0 = torch.where(is_empty[:, :, None], xs[..., 0], LOG_ZERO)
    grow = phi[..., :-1] + xs[..., 1:]  # term at frame t >= 1
    grow = torch.where(frame_mask[:, None, None, 1:], grow, LOG_ZERO)
    psi = _lae(psi0, torch.logsumexp(grow, dim=-1))
    return psi, _parent_eos_score(frame_mask, r_nb_g, r_b_g)


@torch.inference_mode()
def joint_beam_search(
    model,
    enc_out: torch.Tensor,
    enc_lengths: torch.Tensor,
    beam_size: int,
    max_len: int,
    ctc_weight: float = 0.3,
    ctc_prune: int = 30,
    ctc_log_probs: Optional[torch.Tensor] = None,
    lazy: "str | bool" = "auto",
) -> BeamResult:
    """One-pass joint decode: score = (1−λ)·attention + λ·CTC-prefix.

    ``ctc_prune``: CTC prefix scores are evaluated for the top-``P``
    attention candidates per hypothesis (EOS always, through the parent's
    complete-sequence probability). ``ctc_log_probs`` (B, T, C) may be
    precomputed; otherwise the CTC head runs here on the frame-capped
    encoder output. ``ctc_weight=0`` reduces to the attention beam over the
    pruned candidate set. ``lazy``: as ``decode/beam.py::beam_search`` (True
    routes the KV caches through an ancestry map, False gathers them,
    "auto" takes lazy when the model has it)."""
    if lazy == "auto":
        lazy = hasattr(model, "decode_step_lazy")
    # the CTC registers span the batch's longest valid frame count rounded
    # up to 32: frames past every utterance's length change nothing
    t_valid = int(enc_lengths.max())
    t_cap = min(enc_out.shape[1], -(-t_valid // 32) * 32)
    if ctc_log_probs is None:
        ctc_lp = model.ctc_log_probs(enc_out[:, :t_cap])
    else:
        ctc_lp = ctc_log_probs[:, :t_cap]
    ctc_lp = ctc_lp.float()
    bsz, k = enc_out.shape[0], beam_size
    v = ctc_lp.shape[-1]
    p = min(ctc_prune, v)
    t_max = ctc_lp.shape[1]
    lam = float(ctc_weight)
    dev = enc_out.device

    state = init_decode_state(model, enc_out, enc_lengths, max_len + 1, k)
    static, carry_state = state["static"], state["carry"]
    gather_carry = make_gather_carry(bsz, k)

    # (B·C, T) class-major rows: candidate log-probs are a 2-D row gather
    ctc_lp_flat = ctc_lp.transpose(1, 2).reshape(bsz * v, t_max).contiguous()
    frame_mask = torch.arange(t_max, device=dev)[None, :] < enc_lengths.to(dev)[:, None]

    tokens = torch.zeros((bsz, k, max_len + 1), dtype=torch.int64, device=dev)
    tokens[:, :, 0] = BOS_ID
    att = torch.zeros((bsz, k), dtype=torch.float32, device=dev)
    ctc = torch.zeros_like(att)  # cumulative CTC prefix score
    # registers of the empty prefix: r_b = cumulative blank
    blank_cum = torch.cumsum(torch.where(frame_mask, ctc_lp[:, :, BLANK_ID], 0.0), dim=1)
    r_nb = torch.full((bsz, k, t_max), LOG_ZERO, dtype=torch.float32, device=dev)
    r_b = blank_cum[:, None, :].expand(-1, k, -1).contiguous()
    finished = torch.zeros((bsz, k), dtype=torch.bool, device=dev)
    anc = torch.zeros((bsz, k, max_len + 1), dtype=torch.int64, device=dev)
    slots = torch.arange(k, device=dev)
    # at step 0 every slot but 0 holds the same BOS
    dead0 = (slots > 0)[None, :, None]
    no_last = torch.full((bsz, k), -1, dtype=torch.int64, device=dev)

    def sel2(x, parent, slot):  # (B, K, P) -> (B, K) at (parent, slot)
        xp = x.gather(1, parent[:, :, None].expand(-1, -1, x.shape[2]))
        return xp.gather(2, slot[:, :, None])[..., 0]

    i = 0
    while i < max_len and not bool(finished.all()):
        last = tokens[:, :, i].reshape(bsz * k)
        st = {"carry": carry_state, "static": static}
        if lazy:
            anc[:, :, i] = slots[None]  # position i's KV is each slot's own
            logp, st = model.decode_step_lazy(last, st, i, anc)
        else:
            logp, st = model.decode_step(last, st, i)
        carry_new = st["carry"]
        logp = logp.float().reshape(bsz, k, v).clone()
        # PAD/blank, UNK and BOS are never candidate extensions
        logp[:, :, :_SPECIAL_SUPPRESS] = NEG_INF

        # top-P attention candidates; EOS forced into slot P-1 so every
        # hypothesis can terminate
        att_top, cand = _top_k_stable(logp.reshape(bsz * k, v), p)
        att_top = att_top.reshape(bsz, k, p).clone()
        cand = cand.reshape(bsz, k, p).clone()
        cand[:, :, p - 1] = EOS_ID
        att_top[:, :, p - 1] = logp[:, :, EOS_ID]
        is_eos = cand == EOS_ID
        # a natural EOS in an earlier slot would duplicate the forced one
        dup_eos = is_eos.clone()
        dup_eos[:, :, p - 1] = False

        last_tok = tokens[:, :, i] if i > 0 else no_last
        is_empty = i == 0
        psi, eos_sc = _ctc_candidate_scores(
            ctc_lp_flat, frame_mask, r_nb, r_b, cand, last_tok,
            torch.full((bsz, k), is_empty, dtype=torch.bool, device=dev),
        )
        ctc_cand = torch.where(is_eos, eos_sc[:, :, None], psi)  # (B, K, P)

        total = (1.0 - lam) * (att[:, :, None] + att_top) + lam * ctc_cand
        # finished hyps: only the forced-EOS slot stays live, score frozen
        frozen = (1.0 - lam) * att[:, :, None] + lam * ctc[:, :, None]
        total = torch.where(
            finished[:, :, None], torch.where(is_eos, frozen, NEG_INF), total
        )
        # suppressions are additive sentinels on `total`, never scaled by
        # (1 - λ): at ctc_weight=1 a scaled mask would vanish
        kill = dup_eos | dead0 if i == 0 else dup_eos
        total = torch.where(kill, NEG_INF, total)

        _, top_idx = _top_k_stable(total.reshape(bsz, k * p), k)
        parent = top_idx // p  # (B, K)
        slot = top_idx % p

        token = sel2(cand, parent, slot)
        was_finished = finished.gather(1, parent)
        att_par = att.gather(1, parent)
        new_att = torch.where(was_finished, att_par, att_par + sel2(att_top, parent, slot))
        new_ctc = torch.where(was_finished, ctc.gather(1, parent), sel2(ctc_cand, parent, slot))
        # registers advance only for live non-EOS extensions, recursed only
        # for the K selected tokens
        live_ext = ~was_finished & (token != EOS_ID)
        par = parent[:, :, None].expand(-1, -1, t_max)
        par_r_nb, par_r_b = r_nb.gather(1, par), r_b.gather(1, par)
        par_last = last_tok.gather(1, parent)
        r_nb_sel, r_b_sel = ctc_selected_registers(
            ctc_lp_flat, frame_mask, par_r_nb, par_r_b, token, par_last, is_empty
        )
        r_nb = torch.where(live_ext[:, :, None], r_nb_sel, par_r_nb)
        r_b = torch.where(live_ext[:, :, None], r_b_sel, par_r_b)

        parent_l = parent[:, :, None].expand(-1, -1, max_len + 1)
        if lazy:
            anc = anc.gather(1, parent_l)  # only the ancestry map reorders
            carry_state = carry_new
        else:
            carry_state = gather_carry(carry_new, parent)
        tokens = tokens.gather(1, parent_l)
        tokens[:, :, i + 1] = token
        finished = was_finished | (token == EOS_ID)
        att, ctc = new_att, new_ctc
        i += 1

    scores = (1.0 - lam) * att + lam * ctc
    order = torch.argsort(-scores, dim=1, stable=True)
    return BeamResult(
        tokens[:, :, 1:].gather(1, order[:, :, None].expand(-1, -1, max_len)),
        scores.gather(1, order),
        finished.gather(1, order),
    )
