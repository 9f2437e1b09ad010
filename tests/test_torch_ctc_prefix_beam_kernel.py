"""The rescore mode's device CTC prefix beam (K9,
``ops/ctc_prefix_beam_kernel.py``, ``ops/csrc/ctc_prefix_beam.cu``) on the
CPU:

- ``decode/ctc_prefix_device.py::ctc_prefix_beam_device`` on CPU tensors
  (its plain version ``ctc_prefix_beam_reference``) against the JAX
  package's ``ctc_prefix_beam_device`` on the cases of
  ``tests/test_torch_ctc_prefix.py`` and on rows with exact ties
  (duplicated values, the blank inside the top P, dead beams): identical
  prefixes and lengths, scores within 1e-5;
- a rehearsal of the kernel in numpy f32, held against the plain version on
  the same cases (identical prefixes and lengths, scores within 1e-5 of
  max(1, |plain|), the bound ``chip_smoke.py`` holds the kernel to on the
  card). What it keeps of the kernel: the row pass on the frames t < len
  (each of 32 lanes keeps a stable top-P list of the classes c = lane mod
  32 it visits in increasing order, inserting a class only ahead of the
  entries it comes before; then P rounds of an arg-max by (value, index)
  over the lists' heads, the winner's lane popping its head); the
  recursion's order of work per frame (the pair relations from the end of
  the stored tokens, the first equal row per column, the folds, the stay
  candidates with the recreating extensions folded in, the killed
  extensions, the top K as a rank count, the reorder into the other
  buffer, the frozen carry); the last merge and the sort as a rank count;
- the row pass and the rank count alone against ``_top_k_stable`` on rows
  with ties;
- the wrapper's refusals: other devices, non-f32 log-probs, sizes beyond
  the kernel's limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode import ctc_prefix_device as jax_device
from asr_chinese_e2e_tpu_torch.decode import ctc_prefix_device
from asr_chinese_e2e_tpu_torch.decode.beam import _top_k_stable
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_beam_kernel as k9
from tests.test_torch_ctc_prefix import DEVICE_CASES, peaky_log_probs

torch.set_num_threads(2)

F32 = np.float32
BIG = F32(-1e30)
LANES = 32
INT_MAX = 2**31 - 1
REL = 1e-5


def tied_log_probs(seed, b=3, t=25, c=12):
    """Log-probs whose rows repeat values: logits on a grid of four levels,
    the blank at the top level on every third frame."""
    rng = np.random.RandomState(seed)
    logits = rng.randint(0, 4, (b, t, c)).astype(np.float32) * 1.5
    logits[:, ::3, 0] = 4.5
    return torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()


CASES = {**DEVICE_CASES,
         "ties": dict(tied=True, seed=7, beam=6, prune=5, lens=[25, 11, 18]),
         "ties-narrow-vocab": dict(tied=True, seed=8, c=5, beam=8, prune=5, lens=[25, 25, 2])}


def case_inputs(name):
    case = dict(CASES[name])
    lens = np.asarray(case.pop("lens"), np.int32)
    seed, c = case.pop("seed"), case.pop("c", 12)
    if case.pop("tied", False):
        lp = tied_log_probs(seed, c=c)
        case.pop("sharpness", None)
    else:
        lp = peaky_log_probs(seed, c=c, sharpness=case.pop("sharpness"))
    kw = dict(beam_size=case.pop("beam"), prune=case.pop("prune"),
              max_prefix_len=case.pop("max_prefix_len", 64))
    return lp, lens, kw


@pytest.mark.parametrize("name", list(CASES))
def test_dispatcher_on_cpu_matches_jax(name):
    lp, lens, kw = case_inputs(name)
    want = [np.asarray(x) for x in
            jax_device.ctc_prefix_beam_device(jnp.asarray(lp), jnp.asarray(lens), **kw)]
    got = [x.numpy() for x in ctc_prefix_device.ctc_prefix_beam_device(
        torch.from_numpy(lp), torch.from_numpy(lens), **kw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert k9.ctc_prefix_beam_kernel.launches == 0  # CPU: the plain version


# -- the rehearsal of the kernel ---------------------------------------------------


def lae(a, b):
    a, b = F32(a), F32(b)
    return F32(max(a, b) + np.log1p(np.exp(-abs(F32(a - b)), dtype=F32), dtype=F32))


def before(va, ia, vb, ib):
    return va > vb or (va == vb and ia < ib)


def row_pass(row, p):
    """The row pass's top P of one frame row: (values, indices)."""
    lists = []
    for lane in range(LANES):
        lst = [(-np.inf, INT_MAX)] * p
        for c in range(lane, len(row), LANES):
            v = row[c]
            if before(v, c, *lst[p - 1]):
                q = p - 1
                while q > 0 and before(v, c, *lst[q - 1]):
                    lst[q] = lst[q - 1]
                    q -= 1
                lst[q] = (v, c)
        lists.append(lst)
    heads = [0] * LANES
    vals, idx = [], []
    for _ in range(p):
        cands = [lists[lane][heads[lane]] if heads[lane] < p else (-np.inf, INT_MAX)
                 for lane in range(LANES)]
        bv, bi = cands[0]
        for v, i in cands[1:]:  # any reduction order finds the one first element
            if before(v, i, bv, bi):
                bv, bi = v, i
        if bi != INT_MAX:
            heads[bi % LANES] += 1
        vals.append(bv)
        idx.append(bi)
    return np.asarray(vals, F32), np.asarray(idx)


def rank_top_k(scores, k):
    """The kernel's top K: a candidate's rank is the count of candidates
    before it; ranks below K name the selection's slots."""
    sel = [0] * k
    for c, v in enumerate(scores):
        rank = sum(before(scores[o], o, v, c) for o in range(len(scores)))
        if rank < k:
            sel[rank] = c
    return sel


def masked_lse(mask, x):
    contrib = [F32(x[j]) if mask[j] else BIG for j in range(len(x))]
    m = max(contrib)
    s = F32(0.0)
    for v in contrib:
        s = F32(s + np.exp(F32(v - m), dtype=F32))
    out = F32(m + np.log(s, dtype=F32))
    return out if np.isfinite(out) else BIG


def rehearse_kernel(lp, lengths, beam_size, prune, max_prefix_len, blank=0):
    """The kernel's per-utterance recursion over the row pass's output."""
    bsz, t_max, vocab = lp.shape
    k, p, l = beam_size, min(prune, vocab), max_prefix_len
    n = k * (p + 1)
    out_pref = np.zeros((bsz, k, l), np.int64)
    out_plen = np.zeros((bsz, k), np.int64)
    out_scores = np.zeros((bsz, k), F32)
    for b in range(bsz):
        pref = np.zeros((k, l), np.int64)
        plen = [0] * k
        last = [-1] * k
        pb = [F32(0.0)] + [BIG] * (k - 1)
        pnb = [BIG] * k

        def merge():
            rel = np.zeros((k, k), np.int64)  # 1: equal, 2: i is j plus one token
            for i in range(k):
                for j in range(k):
                    li, lj = plen[i], plen[j]
                    nn = li if li == lj else (lj if li == lj + 1 else -1)
                    if nn >= 0:
                        q = min(nn, l) - 1
                        while q >= 0 and pref[i, q] == pref[j, q]:
                            q -= 1
                        if q < 0:
                            rel[i, j] = 1 if li == lj else (2 if li > 0 else 0)
            live = [lae(pb[i], pnb[i]) > BIG / 2 for i in range(k)]
            rep = []
            for j in range(k):
                r = j
                if live[j]:
                    for i in range(j):
                        if rel[i, j] & 1 and live[i]:
                            r = i
                            break
                rep.append(r)
            mpb = [masked_lse([rep[j] == i for j in range(k)], pb) if rep[i] == i else BIG
                   for i in range(k)]
            mpnb = [masked_lse([rep[j] == i for j in range(k)], pnb) if rep[i] == i else BIG
                    for i in range(k)]
            return rel, mpb, mpnb

        for t in range(t_max):
            frame = lp[b, t]
            rel, mpb, mpnb = merge()
            if not t < lengths[b]:
                pb, pnb = mpb, mpnb
                continue
            tv, ti = row_pass(frame, p)
            tv = np.where(ti == blank, BIG, tv)
            p_last = [BIG if last[i] < 0 else F32(frame[last[i]]) for i in range(k)]
            pany = [lae(mpb[i], mpnb[i]) for i in range(k)]
            live = [pa > BIG / 2 for pa in pany]
            staypb = [F32(pa + frame[blank]) for pa in pany]
            cscore = [BIG] * n
            cpnb = [BIG] * n
            par = [[bool(rel[i, j] & 2) and live[i] and live[j] for j in range(k)]
                   for i in range(k)]
            for i in range(k):
                base = [F32((mpb[j] if last[j] == last[i] else pany[j]) + p_last[i])
                        for j in range(k)]
                stay_pnb = lae(F32(mpnb[i] + p_last[i]), masked_lse(par[i], base))
                cscore[i * (p + 1)] = lae(staypb[i], stay_pnb)
                cpnb[i * (p + 1)] = stay_pnb
            for j in range(k):
                for q in range(p):
                    tok = ti[q]
                    ext = F32((mpb[j] if tok == last[j] else pany[j]) + tv[q])
                    if plen[j] >= l or any(par[i][j] and last[i] == tok for i in range(k)):
                        ext = BIG
                    cscore[j * (p + 1) + 1 + q] = cpnb[j * (p + 1) + 1 + q] = ext
            sel = rank_top_k(cscore, k)
            new = np.zeros_like(pref)
            nplen, nlast, npb, npnb = [], [], [], []
            for r, c in enumerate(sel):
                parent, slot = divmod(c, p + 1)
                new[r] = pref[parent]
                if slot > 0:
                    new[r, min(plen[parent], l - 1)] = ti[slot - 1]
                    nplen.append(plen[parent] + 1)
                    nlast.append(int(ti[slot - 1]))
                    npb.append(BIG)
                    npnb.append(cpnb[c])
                else:
                    nplen.append(plen[parent])
                    nlast.append(last[parent])
                    npb.append(staypb[parent])
                    npnb.append(cpnb[parent * (p + 1)])
            pref, plen, last, pb, pnb = new, nplen, nlast, npb, npnb
        _, mpb, mpnb = merge()
        scores = [lae(mpb[i], mpnb[i]) for i in range(k)]
        for i in range(k):
            rank = sum(before(scores[o], o, scores[i], i) for o in range(k))
            out_pref[b, rank], out_plen[b, rank], out_scores[b, rank] = pref[i], plen[i], scores[i]
    return out_pref, out_plen, out_scores


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_rehearsal_matches_plain(name):
    lp, lens, kw = case_inputs(name)
    want = [x.numpy() for x in ctc_prefix_device.ctc_prefix_beam_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), **kw)]
    got = rehearse_kernel(lp, lens, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rel = np.abs(got[2] - want[2]) / np.maximum(1.0, np.abs(want[2]))
    assert rel.max() <= REL, rel.max()


# -- the tie rules alone --------------------------------------------------------------


@pytest.mark.parametrize("c,p", [(12, 5), (70, 8), (4233, 32), (33, 1)])
def test_row_pass_equals_top_k_stable(c, p):
    """Rows of few distinct values (every class ties with many), the top
    level repeated across lanes and within one lane."""
    rng = np.random.RandomState(c + p)
    rows = rng.randint(0, 3, (4, c)).astype(F32) - 2.0
    rows[1, ::32] = 1.0  # the best value, all in lane 0
    rows[2] = -3.5  # one value everywhere
    want_v, want_i = _top_k_stable(torch.from_numpy(rows), p)
    for r, row in enumerate(rows):
        v, i = row_pass(row, p)
        np.testing.assert_array_equal(i, want_i[r].numpy())
        np.testing.assert_array_equal(v, want_v[r].numpy())


def test_rank_top_k_equals_top_k_stable():
    """Candidates with many exact ties at BIG_NEG (killed extensions, dead
    beams, full prefixes) and at equal finite scores."""
    rng = np.random.RandomState(3)
    for k, p in ((10, 8), (6, 5), (32, 32), (4, 1)):
        scores = rng.choice(np.asarray([-1e30, -2e30, -3.0, -1.5, -7.25], F32), k * (p + 1))
        scores[: k // 2] = -1e30  # the first candidates all killed
        _, want = _top_k_stable(torch.from_numpy(scores)[None], k)
        assert rank_top_k(list(scores), k) == want[0].tolist()


# -- the wrapper's refusals ---------------------------------------------------------------


def _inputs(b=2, t=5, c=7, dtype=torch.float32, device="cpu"):
    lp = torch.log_softmax(torch.randn(b, t, c, generator=torch.Generator().manual_seed(0)), -1)
    return lp.to(dtype).to(device), torch.full((b,), t, dtype=torch.int64, device=device)


@pytest.mark.parametrize("kw,match", [
    (dict(), "needs CUDA tensors"),
    (dict(dtype=torch.float64), "f32 log-probs"),
    (dict(dtype=torch.bfloat16), "f32 log-probs"),
    (dict(beam_size=33), "beam_size 33 outside"),
    (dict(prune=33, c=40), "prune 33 outside"),
    (dict(max_prefix_len=129), "max_prefix_len 129 outside"),
    (dict(beam_size=0), "beam_size 0 outside"),
])
def test_kernel_wrapper_refuses(kw, match):
    lp, lens = _inputs(c=kw.pop("c", 7), dtype=kw.pop("dtype", torch.float32))
    args = {"beam_size": 4, "prune": 3, "max_prefix_len": 8, **kw}
    with pytest.raises(ValueError, match=match):
        k9.ctc_prefix_beam_kernel(lp, lens, **args)
    assert k9.ctc_prefix_beam_kernel.launches == 0


def test_dispatcher_refuses_other_devices():
    lp, lens = _inputs(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_prefix_device.ctc_prefix_beam_device(lp, lens)


def test_prune_wider_than_the_vocabulary_is_within_the_limits():
    """P = min(prune, C), as the plain version takes it: a prune of 40 over
    7 classes passes the limits and meets only the device check."""
    lp, lens = _inputs(c=7)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        k9.ctc_prefix_beam_kernel(lp, lens, beam_size=4, prune=40, max_prefix_len=8)
