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
  the same cases and on cases at its edges (prefixes reaching L = 4 and 8
  on long peaky rows, a stay whose parent prefix is recreated by an
  extension, beam 32 with prune 32, beams dead from the first frame, empty
  utterances): identical prefixes and lengths, scores within 1e-5 of
  max(1, |plain|), the bound ``chip_smoke.py`` holds the kernel to on the
  card. What it keeps of the kernel: the row pass on the frames t < len
  (128 threads a row, each keeping a sorted list of the classes c = tid
  mod 128 it visits in increasing order, inserting a class only ahead of
  the entries it comes before; each warp merges its 32 lists, then four
  warp lists are merged, P rounds each of the largest order key and the
  least index holding it); the warp search's order of work per frame (the
  stay with its one folded extension, the killed extensions, the
  candidates in contiguous blocks of ceil(K (P + 1) / 32) a lane, K rounds
  of the lowest lane holding the largest key, the token rows of a pool, a
  parent's first child in place and the others copying, the folds at the
  end of the frame, the parent relation carried, and the one token
  compare: a stay whose parent was in no beam against the extensions one
  token shorter that match it); the sort of the last beams as a rank
  count;
- the fold of one row, the row pass, the rank count and the selection's
  rounds alone against ``_masked_logsumexp`` and ``_top_k_stable``, ties
  included;
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
ROW_THREADS = 128  # four warps a row
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
         "ties-narrow-vocab": dict(tied=True, seed=8, c=5, beam=8, prune=5, lens=[25, 25, 2]),
         # long peaky rows whose prefixes reach L: full beams, slot L - 1 overwritten
         "overflow-L4": dict(seed=11, t=60, sharpness=4.0, beam=6, prune=6, lens=[60, 41, 60],
                             max_prefix_len=4),
         "overflow-L8": dict(seed=12, t=60, sharpness=4.0, beam=8, prune=4, lens=[60, 60, 23],
                             max_prefix_len=8),
         # a stay whose parent prefix was in no beam, recreated by an extension
         "stay-recreated": dict(seed=13, c=4, sharpness=1.5, beam=4, prune=3, lens=[25, 25, 25]),
         "beam32-prune32": dict(seed=14, c=40, sharpness=2.0, beam=32, prune=32,
                                lens=[12, 9, 5]),
         # more beams than live candidates at the first frames; empty and 1-frame utterances
         "dead-from-start": dict(tied=True, seed=15, c=3, beam=12, prune=2, lens=[25, 0, 1])}


def case_inputs(name):
    case = dict(CASES[name])
    lens = np.asarray(case.pop("lens"), np.int32)
    seed, c, t = case.pop("seed"), case.pop("c", 12), case.pop("t", 25)
    if case.pop("tied", False):
        lp = tied_log_probs(seed, t=t, c=c)
        case.pop("sharpness", None)
    else:
        lp = peaky_log_probs(seed, t=t, c=c, sharpness=case.pop("sharpness"))
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
    if np.isinf(a) and a == b:
        return a
    return F32(max(a, b) + np.log1p(np.exp(-abs(F32(a - b)), dtype=F32), dtype=F32))


def before(va, ia, vb, ib):
    return va > vb or (va == vb and ia < ib)


def order_key(v):
    """The kernel's 32-bit key of an f32: unsigned order is the floats'
    order, -0 taken as +0 (they tie in the plain version's sort)."""
    bits = int(np.asarray(F32(v) + F32(0.0), F32).view(np.uint32))
    return bits ^ 0xFFFFFFFF if bits & 0x80000000 else bits | 0x80000000


def warp_pick(heads):
    """One round of the warp's arg-max over (value, index) heads: the largest
    key, then the smallest index among the lanes that hold it (two warp
    reductions); returns the winning lane, or None if every lane is empty."""
    keys = [order_key(v) if i != INT_MAX else 0 for v, i in heads]
    m = max(keys)
    idx = min(i for (v, i), k in zip(heads, keys) if k == m)
    if idx == INT_MAX:
        return None
    return next(lane for lane, (v, i) in enumerate(heads) if i == idx)


def row_pass(row, p):
    """The row pass's top P of one frame row: (values, indices). Four warps
    a row: thread ``tid`` keeps a sorted list of the PMAX (P rounded up to a
    power of two) best of the classes c = tid (mod 128), visited in
    increasing order and inserted only ahead of the entries they come before;
    each warp merges its 32 lists by P rounds of ``warp_pick`` over the
    lists' heads, the winner popping its head; lanes 0-3 of one warp merge
    the four warp lists the same way."""
    pmax = 1 << (p - 1).bit_length()
    lists = []
    for tid in range(ROW_THREADS):
        lst = [(-np.inf, INT_MAX)] * pmax
        for c in range(tid, len(row), ROW_THREADS):
            v = F32(row[c])
            if before(v, c, *lst[-1]):
                q = pmax - 1
                while q > 0 and before(v, c, *lst[q - 1]):
                    lst[q] = lst[q - 1]
                    q -= 1
                lst[q] = (v, c)
        lists.append(lst)

    def merge(lists):
        lists = [list(lst) for lst in lists]
        out = []
        for _ in range(p):
            heads = [lst[0] if lst else (-np.inf, INT_MAX) for lst in lists]
            w = warp_pick(heads)
            out.append(heads[w] if w is not None else (-np.inf, INT_MAX))
            if w is not None:
                lists[w].pop(0)
        return out

    warps = [merge(lists[w * LANES:(w + 1) * LANES]) for w in range(ROW_THREADS // LANES)]
    top = merge(warps)
    return np.asarray([v for v, _ in top], F32), np.asarray([i for _, i in top])


def rank_top_k(scores, k):
    """A rank count, as the kernel's last sort of the K beams: an entry's
    rank is the count of entries before it; ranks below K name the order's
    slots."""
    sel = [0] * k
    for c, v in enumerate(scores):
        rank = sum(before(scores[o], o, v, c) for o in range(len(scores)))
        if rank < k:
            sel[rank] = c
    return sel


def fold1(x, k):
    """The plain version's masked log-sum-exp over K entries of which one,
    ``x``, is unmasked (the others count as BIG_NEG), as the kernel takes
    it: x + 0 where x is finite and, for K > 1, above BIG_NEG, else BIG_NEG
    (bit for bit: -0 comes out +0, as m + log 1 does)."""
    x = F32(x)
    return F32(x + F32(0.0)) if np.isfinite(x) and (k == 1 or x > BIG) else BIG


def pack(v, slot):
    """A candidate's place in its lane's stable order: its value's order key
    above, the complement of its slot below; larger is first."""
    return order_key(v) << 32 | (0xFFFFFFFF - slot)


class Frame:
    """One frame of one utterance: the K beams' lanes before the selection."""

    def __init__(self, st, tv, ti, p_blank, p_last, k, p, l, blank):
        self.st, self.k, self.p, self.l = st, k, p, l
        self.ti = ti
        self.tvx = np.where(ti == blank, BIG, tv).astype(F32)  # the blank is no extension
        live = st["live"]
        self.staypb = [F32(st["pany"][i] + p_blank) for i in range(k)]
        self.stay_pnb, self.stay_score = [], []
        for i in range(k):  # the stay, with the one extension that recreates it folded in
            j = st["par"][i]
            member = j >= 0 and live[i] and live[j]
            base = (st["mpb"][j] if st["last"][j] == st["last"][i] else st["pany"][j]) if member \
                else BIG
            csum = fold1(F32(base + p_last[i]) if member else BIG, k)
            spnb = lae(F32(st["mpnb"][i] + p_last[i]), csum)
            self.stay_pnb.append(spnb)
            self.stay_score.append(lae(self.staypb[i], spnb))
        # where each beam's last token stands in the frame's top P
        self.pos = [next((q for q in range(p) if ti[q] == st["last"][i]), -1) for i in range(k)]
        self.kill = [0] * k  # an extension that recreates a live child of its beam
        for i in range(k):
            j = st["par"][i]
            if j >= 0 and live[i] and live[j] and self.pos[i] >= 0:
                self.kill[j] |= 1 << self.pos[i]

    def value(self, j, slot):
        if slot == 0:
            return self.stay_score[j]
        q = slot - 1
        if self.st["plen"][j] >= self.l or self.kill[j] >> q & 1:
            return BIG
        base = self.st["mpb"][j] if self.ti[q] == self.st["last"][j] else self.st["pany"][j]
        return F32(base + self.tvx[q])

    def select(self):
        """The K (P + 1) candidates c = j (P + 1) + slot in contiguous blocks
        of U = ceil(K (P + 1) / 32) a lane, each packed with its place in
        the block; a lane's head is its largest; K rounds: the lowest lane
        that holds the largest order key (so the lowest index among equal
        values) wins (a warp reduction and a ballot) and pops its head.
        Returns [(parent, slot)]."""
        n = self.k * (self.p + 1)
        per = -(-n // LANES)
        blocks = [[pack(self.value(*divmod(c, self.p + 1)), c - lane * per)
                   for c in range(lane * per, min(n, (lane + 1) * per))]
                  for lane in range(LANES)]
        sel = []
        for _ in range(self.k):
            heads = [max(block) if block else 0 for block in blocks]
            keys = [h >> 32 for h in heads]
            w = keys.index(max(keys))
            blocks[w].remove(heads[w])
            sel.append(divmod(w * per + 0xFFFFFFFF - (heads[w] & 0xFFFFFFFF), self.p + 1))
        return sel


def rehearse_kernel(lp, lengths, beam_size, prune, max_prefix_len, blank=0, seen=None):
    """The kernel's warp per utterance over the row pass's output. ``seen``
    counts the pair relations the kernel finds by comparing tokens."""
    bsz, t_max, vocab = lp.shape
    k, p, l = beam_size, min(prune, vocab), max_prefix_len
    out_pref = np.zeros((bsz, k, l), np.int64)
    out_plen = np.zeros((bsz, k), np.int64)
    out_scores = np.zeros((bsz, k), F32)

    def fold(st, pb, pnb):
        """The merge, folded into the end of a frame: live beams are
        distinct strings, so each row folds only itself."""
        st["mpb"] = [fold1(x, k) for x in pb]
        st["mpnb"] = [fold1(x, k) for x in pnb]
        st["pany"] = [lae(a, b) for a, b in zip(st["mpb"], st["mpnb"])]
        st["live"] = [pa > BIG / 2 for pa in st["pany"]]

    for b in range(bsz):
        tokens = np.zeros((k, l), np.int64)  # the token rows, a pool of K
        st = dict(plen=[0] * k, last=[-1] * k, par=[-1] * k, row=list(range(k)))
        fold(st, [F32(0.0)] + [BIG] * (k - 1), [BIG] * k)
        for t in range(min(int(lengths[b]), t_max)):
            frame = lp[b, t]
            tv, ti = row_pass(frame, p)
            p_last = [BIG if x < 0 else F32(frame[x]) for x in st["last"]]
            fr = Frame(st, tv, ti, F32(frame[blank]), p_last, k, p, l, blank)
            sel = [(a, s, fr.value(a, s)) for a, s in fr.select()]
            # the token rows: a parent's first child keeps its row, the others
            # take the rows of the beams that have no child, in order
            parents = [a for a, _, _ in sel]
            first = [parents.index(a) == r for r, a in enumerate(parents)]
            free = [st["row"][a] for a in range(k) if a not in parents]
            new_row, n_free = [], 0
            for r, a in enumerate(parents):
                if first[r]:
                    new_row.append(st["row"][a])
                else:
                    new_row.append(free[n_free])
                    n_free += 1
            for r, a in enumerate(parents):  # copies first ...
                if not first[r]:
                    n = min(st["plen"][a], l)
                    tokens[new_row[r], :n] = tokens[st["row"][a], :n]
            nplen, nlast, npb, npnb = [], [], [], []
            for r, (a, s, v) in enumerate(sel):  # ... then the new tokens
                if s > 0:
                    tokens[new_row[r], min(st["plen"][a], l - 1)] = ti[s - 1]
                    nplen.append(st["plen"][a] + 1)
                    nlast.append(int(ti[s - 1]))
                    npb.append(BIG)
                    npnb.append(v)
                else:
                    nplen.append(st["plen"][a])
                    nlast.append(st["last"][a])
                    npb.append(fr.staypb[a])
                    npnb.append(fr.stay_pnb[a])
            old_par, old_live = st["par"], st["live"]
            st = dict(plen=nplen, last=nlast, row=new_row)
            fold(st, npb, npnb)
            # the parent relation, carried: an extension's parent is its
            # parent's stay; a stay's is the stay of its parent's parent ...
            stay_pos = {a: r for r, (a, s, _) in enumerate(sel) if s == 0}
            par, seek = [], []
            for r, (a, s, _) in enumerate(sel):
                if s > 0:
                    par.append(stay_pos.get(a, -1))
                elif old_par[a] >= 0 and old_live[old_par[a]]:
                    par.append(stay_pos.get(old_par[a], -1))
                else:
                    par.append(-1)
                    seek.append(r)
            # ... or, for a live stay whose parent was in no beam, an extension
            # of this frame that spells it: a match on (length, last token)
            # against (length - 1, second to last), then the stored tokens
            targets = {r2 for r2, (_, s2, _) in enumerate(sel) if s2 > 0 and st["live"][r2]}
            for r in seek:
                if not st["live"][r] or nplen[r] < 2:
                    continue
                want = (nplen[r] - 1, tokens[new_row[r], nplen[r] - 2])
                for r2 in sorted(targets):
                    n = nplen[r2]
                    if (n, nlast[r2]) == want and np.array_equal(
                            tokens[new_row[r], :n - 1], tokens[new_row[r2], :n - 1]):
                        par[r] = r2
                        if seen is not None:
                            seen["compared"] = seen.get("compared", 0) + 1
                        break
            st["par"] = par
        scores = st["pany"]
        for rank, i in enumerate(rank_top_k(scores, k)):
            n = min(st["plen"][i], l)
            out_pref[b, rank, :n] = tokens[st["row"][i], :n]
            out_plen[b, rank], out_scores[b, rank] = st["plen"][i], scores[i]
    return out_pref, out_plen, out_scores


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_rehearsal_matches_plain(name):
    lp, lens, kw = case_inputs(name)
    want = [x.numpy() for x in ctc_prefix_device.ctc_prefix_beam_reference(
        torch.from_numpy(lp), torch.from_numpy(lens), **kw)]
    seen = {}
    got = rehearse_kernel(lp, lens, **kw, seen=seen)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    rel = np.abs(got[2] - want[2]) / np.maximum(1.0, np.abs(want[2]))
    assert rel.max() <= REL, rel.max()
    if name == "stay-recreated":  # the relation that does not carry was met
        assert seen.get("compared", 0) >= 1


# -- the tie rules alone --------------------------------------------------------------


@pytest.mark.parametrize("c,p", [(12, 5), (70, 8), (4233, 32), (33, 1), (300, 3), (129, 16)])
def test_row_pass_equals_top_k_stable(c, p):
    """Rows of few distinct values (every class ties with many), the top
    level repeated across threads and within one thread."""
    rng = np.random.RandomState(c + p)
    rows = rng.randint(0, 3, (4, c)).astype(F32) - 2.0
    rows[1, ::32] = 1.0  # the best value, all in lane 0 of warp 0
    rows[2] = -3.5  # one value everywhere
    rows[3, 5::128] = 0.5  # the best value, all in one thread of the row
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


@pytest.mark.parametrize("k", [1, 2, 10, 32])
def test_fold1_is_the_masked_log_sum_exp(k):
    """The kernel's fold of one row against ``_masked_logsumexp`` with that
    row alone unmasked, at each place of the row: finite values, BIG_NEG,
    values below and above it, the infinities."""
    xs = np.asarray([0.0, -0.0, -3.5, -1e30, -2e30, -9.9e29, -1e31, -np.inf, np.inf], F32)
    for x in xs:
        for i in range(k):
            mask = torch.zeros((1, 1, k), dtype=torch.bool)
            mask[0, 0, i] = True
            row = torch.full((1, 1, k), float(x))
            want = ctc_prefix_device._masked_logsumexp(mask, row)[0, 0].item()
            got = np.asarray(fold1(x, k), F32)
            assert got.view(np.uint32) == np.asarray(want, F32).view(np.uint32), (x, i)


@pytest.mark.parametrize("k,p", [(10, 8), (6, 5), (32, 32), (4, 1), (1, 3)])
def test_warp_merge_equals_top_k_stable(k, p):
    """The selection's K rounds over the lanes' lists against
    ``_top_k_stable`` on the K (P + 1) candidates: beams live and dead, full
    prefixes, killed extensions, a blank in the top P, the last token among
    the classes, ties in the frame's values and at BIG_NEG, -0 beside +0."""
    rng = np.random.RandomState(k * 100 + p)
    for trial in range(20):
        levels = np.asarray([-0.0, 0.0, -1.5, -3.0, -1e30], F32)
        tv = rng.choice(levels[:4], p).astype(F32)
        ti = rng.permutation(p + 3)[:p]
        order = np.lexsort((ti, -tv))  # the row pass's order: value, then index
        tv, ti = tv[order], ti[order]
        live = rng.rand(k) < 0.7
        mpb = np.where(live, rng.choice(levels[:4], k), BIG).astype(F32)
        mpnb = np.where(live, rng.choice(levels[:4], k), BIG).astype(F32)
        st = dict(plen=list(rng.randint(0, 4, k)), last=list(rng.randint(-1, p + 3, k)),
                  mpb=list(mpb), mpnb=list(mpnb), par=[-1] * k)
        st["pany"] = [lae(a, b) for a, b in zip(mpb, mpnb)]
        st["live"] = [pa > BIG / 2 for pa in st["pany"]]
        for i in range(1, k):  # a few live children of live beams
            j = int(rng.randint(0, i))
            if st["live"][i] and st["live"][j] and rng.rand() < 0.5:
                st["par"][i] = j
        fr = Frame(st, tv, ti, F32(rng.choice(levels[:4])),
                   [F32(rng.choice(levels[:4])) for _ in range(k)], k, p, 3, blank=0)
        scores = [fr.value(j, s) for j in range(k) for s in range(p + 1)]
        _, want = _top_k_stable(torch.from_numpy(np.asarray(scores, F32))[None], k)
        got = [w * (p + 1) + s for w, s in fr.select()]
        assert got == want[0].tolist(), trial


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
