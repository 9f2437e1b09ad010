"""CPU rehearsal of the tensor-core windowed causal-band attention kernels
(K6 and K7 for bf16 inputs, ``ops/csrc/banded_attention.cu``): a plain torch
emulation of their arithmetic with their rounding points, held against the
f32 plain versions within the bound the kernels are held to on the card; and
the wrapper's one validation per attention call.

What the emulation keeps of the kernels: bf16 q, k, v and dO; f32 scores in
units of log 2 and ``exp2`` of a plain difference; a masked score is -inf in
K6 and weighs 0 in K7 (no -1e9 bias: every row below its length sees a key);
a warp of 16 owned rows visits the 16-row groups of the other side that its
band reaches (K6 and K7's dQ pass ``CHUNK`` = 5 groups at a time, K6 carrying
the (max, sum) pair from chunk to chunk; the dK/dV pass one group at a time);
the weights times the keep mask (and dS) split into
hi + lo bf16 parts before each product that takes them as an operand; D =
rowsum(dP o M o W) from the f32 weights; W recomputed from the row
log-sum-exp; outputs rounded to bf16; rows, warps and blocks past the length
give zeros. The group ranges are mirrored here by hand (``query_warp_groups``
and ``key_warp_groups``) and must change together with the CUDA kernels; the
kernels' own ranges are held to the plain versions on the card, by
``chip_smoke.py`` at the same bands. Visiting the groups a warp skips (in
chunks before and after the ones it visits) must leave every result
bit-identical: their weights are exactly 0.
A product of bf16 operands with f32 accumulation is an f32 matmul of the
same values (only the order of the sums differs).
"""

import functools
import math

import pytest
import torch

import chip_smoke
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa

TILE = 64    # ATT_TILE: rows owned by a block, and of a resident tile
GROUP = 16   # rows owned by a warp, and of a group of the other side
CHUNK = 5    # groups a warp holds in accumulators at once
BOUND = 2e-2  # the card's bf16 bound, absolute, against the f32 plain version
LOG2E = math.log2(math.e)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The emulation is thousands of small products: with every core's
    thread spinning on each, two test files side by side starve one
    another (minutes instead of seconds)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def split_matmul(a, b, split=True):
    """(hi + lo) @ b with hi = bf16(a), lo = bf16(a - hi): the two products
    the kernels make for an f32 operand; ``split=False``: hi alone."""
    hi = a.to(torch.bfloat16).float()
    if not split:
        return hi @ b
    lo = (a - hi).to(torch.bfloat16).float()
    return hi @ b + lo @ b


def query_warp_groups(rw, band):
    """Key groups [lo, hi] that hold every key the query rows [rw, rw + 15]
    see: keys [rw - band, rw + 15]."""
    return max(rw - band, 0) // GROUP, rw // GROUP


def key_warp_groups(jw, band, n):
    """Query groups [lo, hi] that hold every row below n that sees the keys
    [jw, jw + 15]: rows [jw, jw + 15 + band]."""
    return jw // GROUP, min(jw + 15 + band, n - 1) // GROUP


def _chunked(groups):
    return [groups[i : i + CHUNK] for i in range(0, len(groups), CHUNK)]


def chunks_of(g_lo, g_hi, first, last, skip):
    """The chunks of groups a warp visits, in order. ``skip=False`` adds the
    groups of the block's resident tiles [first, last] that the warp skips,
    in chunks of their own before and after, so the visited chunks keep
    their boundaries."""
    visited = _chunked(list(range(g_lo, g_hi + 1)))
    if skip:
        return visited
    return (_chunked(list(range(first, g_lo))) + visited
            + _chunked(list(range(g_hi + 1, last + 1))))


def _group_rows(groups, t):
    """Indices of the groups' rows that exist (a resident tile may end past T)."""
    return torch.cat([torch.arange(min(g * GROUP, t), min((g + 1) * GROUP, t)) for g in groups])


def emulate_forward(q, k, v, n, seed, scale, rate, band, skip=True, split=True):
    """(out bf16, lse f32) as banded_fwd_mma_kernel computes them."""
    bsz, heads, t, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(bsz, heads, t, d)
    lse = torch.zeros(bsz, heads, t)
    keep = fa.keep_mask_reference(seed, bsz, heads, t, t, rate) if rate > 0 else None
    scale2 = scale * LOG2E
    for b in range(bsz):
        nb = min(int(n[b]), t)
        for r0 in range(0, t, TILE):
            if r0 >= nb:
                continue  # the block writes zeros
            first = max(r0 - band, 0) // TILE * (TILE // GROUP)
            last = r0 // TILE * (TILE // GROUP) + TILE // GROUP - 1
            for rw in range(r0, min(r0 + TILE, t), GROUP):
                if skip and rw >= nb:
                    continue  # the warp writes zeros
                rows = torch.arange(rw, min(rw + GROUP, t))
                m = torch.full((heads, len(rows)), -math.inf)
                l = torch.zeros(heads, len(rows))
                o = torch.zeros(heads, len(rows), d)
                chunks = chunks_of(*query_warp_groups(rw, band), first, last, skip)
                for c, groups in enumerate(chunks):
                    cols = _group_rows(groups, t)
                    if len(cols) == 0:
                        continue
                    i, j = rows[:, None], cols[None, :]
                    seen = (j >= i - band) & (j <= i) & (i < nb)
                    s = qf[b][:, rows] @ kf[b][:, cols].transpose(-1, -2)
                    s = torch.where(seen, s * scale2, torch.tensor(-math.inf))
                    m_new = torch.maximum(m, s.max(-1).values)
                    base = torch.where(m_new == -math.inf, torch.zeros(()), m_new)
                    corr = torch.exp2(m - base)
                    w = torch.exp2(s - base[..., None])
                    l = l * corr + w.sum(-1)
                    if keep is not None:
                        w = w * keep[b][:, rows][:, :, cols]
                    if c > 0:
                        o = o * corr[..., None]
                    for x in range(0, len(cols), GROUP):  # one product per group
                        o = o + split_matmul(w[..., x : x + GROUP],
                                             vf[b][:, cols[x : x + GROUP]], split)
                    m = m_new
                live = l > 0
                norm = torch.where(live, 1.0 / l, torch.zeros(()))
                out[b][:, rows] = o * norm[..., None]
                lse[b][:, rows] = torch.where(
                    live, m * math.log(2.0) + torch.log(l), torch.zeros(()))
    return out.to(torch.bfloat16), lse


def emulate_backward(q, k, v, lse, n, seed, scale, rate, band, dout, skip=True,
                     d_from_output=None):
    """(dq, dk, dv) bf16 as banded_bwd_dq_mma_kernel and
    banded_bwd_dkdv_mma_kernel compute them. ``d_from_output``: the bf16
    forward output, to take D = rowsum(dO o O) from it as K2 does, instead
    of from the f32 weights."""
    bsz, heads, t, d = q.shape
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    keep = fa.keep_mask_reference(seed, bsz, heads, t, t, rate) if rate > 0 else None
    scale2 = scale * LOG2E
    dq = torch.zeros(bsz, heads, t, d)
    dk = torch.zeros(bsz, heads, t, d)
    dv = torch.zeros(bsz, heads, t, d)
    delta = torch.zeros(bsz, heads, t)
    groups_per_tile = TILE // GROUP

    def keep_of(b, rows, cols):
        return keep[b][:, rows][:, :, cols] if keep is not None else 1.0

    for b in range(bsz):
        nb = min(int(n[b]), t)
        nl2 = torch.where(torch.arange(t) < nb, -lse[b] * LOG2E, torch.zeros(()))
        for r0 in range(0, t, TILE):  # the dQ pass
            if r0 >= nb:
                continue
            first = max(r0 - band, 0) // TILE * groups_per_tile
            last = r0 // TILE * groups_per_tile + groups_per_tile - 1
            for rw in range(r0, min(r0 + TILE, t), GROUP):
                if skip and rw >= nb:
                    continue
                rows = torch.arange(rw, min(rw + GROUP, t))
                chunks = chunks_of(*query_warp_groups(rw, band), first, last, skip)

                def weights(groups):
                    """(W, dW = dP o M, key indices) of one chunk."""
                    cols = _group_rows(groups, t)
                    i, j = rows[:, None], cols[None, :]
                    seen = (j >= i - band) & (j <= i) & (i < nb)
                    s = qf[b][:, rows] @ kf[b][:, cols].transpose(-1, -2)
                    dp = gf[b][:, rows] @ vf[b][:, cols].transpose(-1, -2)
                    w = torch.where(seen, torch.exp2(s * scale2 + nl2[:, rows, None]),
                                    torch.zeros(()))
                    return w, dp * keep_of(b, rows, cols), cols

                di = torch.zeros(heads, len(rows))
                for groups in chunks:  # one chunk: the same sweep as below
                    w, dw, _ = weights(groups)
                    di = di + (w * dw).sum(-1)
                if d_from_output is not None:
                    di = (d_from_output[b][:, rows].float() * gf[b][:, rows]).sum(-1)
                acc = torch.zeros(heads, len(rows), d)
                for groups in chunks:
                    w, dw, cols = weights(groups)
                    ds = w * (dw - di[..., None])
                    for x in range(0, len(cols), GROUP):
                        acc = acc + split_matmul(ds[..., x : x + GROUP],
                                                 kf[b][:, cols[x : x + GROUP]])
                dq[b][:, rows] = acc * scale
                delta[b][:, rows] = di
        for j0 in range(0, t, TILE):  # the dK / dV pass
            if j0 >= nb:
                continue
            first = j0 // TILE * groups_per_tile
            last = min(j0 + TILE - 1 + band, nb - 1) // TILE * groups_per_tile \
                + groups_per_tile - 1
            for jw in range(j0, min(j0 + TILE, t), GROUP):
                if skip and jw >= nb:
                    continue
                keys = torch.arange(jw, min(jw + GROUP, t))
                g_lo, g_hi = key_warp_groups(jw, band, nb)
                dka = torch.zeros(heads, len(keys), d)
                dva = torch.zeros(heads, len(keys), d)
                for gq in range(g_lo, g_hi + 1) if skip else range(first, last + 1):
                    rows = _group_rows([gq], t)  # this pass takes one group at a time
                    if len(rows) == 0:
                        continue
                    j, i = keys[:, None], rows[None, :]
                    seen = (i >= j) & (i <= torch.clamp(j + band, max=nb - 1)) & (j < nb)
                    st = kf[b][:, keys] @ qf[b][:, rows].transpose(-1, -2)
                    dpt = vf[b][:, keys] @ gf[b][:, rows].transpose(-1, -2)
                    w = torch.where(seen, torch.exp2(st * scale2 + nl2[:, None, rows]),
                                    torch.zeros(()))
                    kp = keep_of(b, rows, keys)
                    kp = kp.transpose(-1, -2) if keep is not None else kp
                    wm = w * kp
                    ds = w * (dpt * kp - delta[b][:, None, rows])
                    dva = dva + split_matmul(wm, gf[b][:, rows])
                    dka = dka + split_matmul(ds, qf[b][:, rows])
                dk[b][:, keys] = dka * scale
                dv[b][:, keys] = dva
    bf16 = torch.bfloat16
    return dq.to(bf16), dk.to(bf16), dv.to(bf16)


# name: (batch, T, head dim, band, rate, lengths or None for ragged rows of
# chip_smoke._attn_inputs): the streaming training shape (batch cut to 4)
# with and without hash dropout, the bands at either side of one chunk (64 /
# 65) and of BQ, head dim 32, the short segments of the prefix re-encode, a
# length that is no multiple of 16, and a band wider than the utterance
CASES = {
    "train-band50-dropout0.1": (4, 267, 64, 50, 0.1, None),
    "train-band50": (4, 267, 64, 50, 0.0, None),
    "band30": (2, 267, 64, 30, 0.1, None),
    "band64": (2, 267, 64, 64, 0.1, None),
    "band65": (2, 267, 64, 65, 0.1, None),
    "band128": (2, 267, 64, 128, 0.1, [267, 201]),
    "head-dim-32": (2, 267, 32, 50, 0.1, None),
    "head-dim-32-band128": (2, 150, 32, 128, 0.0, [150, 97]),
    "segment-67": (1, 67, 64, 50, 0.0, [67]),
    "segment-11": (1, 11, 64, 50, 0.1, [11]),
    "ragged-97": (2, 150, 64, 30, 0.0, [150, 97]),
    "band300-over-T": (1, 267, 64, 300, 0.1, [250]),
}
HEADS = 8


def _inputs(name):
    bsz, t, d, band, rate, lengths = CASES[name]
    seed = 200 + list(CASES).index(name)
    q, k, v, n, _ = chip_smoke._attn_inputs(bsz, HEADS, t, t, d, "cpu", seed)
    if lengths is not None:
        n = torch.tensor(lengths, dtype=torch.int32)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed))
    qb, kb, vb, gb = (x.to(torch.bfloat16) for x in (q, k, v, g))
    return qb, kb, vb, gb, (n, 4321, d**-0.5, rate, band)


@functools.lru_cache(maxsize=None)
def run_case(name):
    """The emulation with and without group skipping, and the f32 plain
    versions, on the same bf16 inputs."""
    qb, kb, vb, gb, args = _inputs(name)
    res = {}
    for skip in (True, False):
        out, lse = emulate_forward(qb, kb, vb, *args, skip)
        grads = emulate_backward(qb, kb, vb, lse, *args, gb, skip)
        res[skip] = (out, lse, *grads)
    plain = (qb.float(), kb.float(), vb.float())
    res["want"] = fa.banded_attention_reference(*plain, *args)
    res["want_grads"] = fa.banded_attention_backward_reference(*plain, *args, gb.float())
    return res


@pytest.mark.parametrize("name", list(CASES))
def test_forward_rounding_within_card_bound(name):
    res = run_case(name)
    out = res[True][0]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - res["want"]).abs().max().item() <= BOUND


@pytest.mark.parametrize("name", list(CASES))
def test_backward_rounding_within_card_bound(name):
    res = run_case(name)
    for what, got, want in zip(("dq", "dk", "dv"), res[True][2:], res["want_grads"]):
        assert torch.isfinite(got.float()).all(), what
        assert (got.float() - want).abs().max().item() <= BOUND, what


@pytest.mark.parametrize("name", list(CASES))
def test_group_skipping_is_bit_identical(name):
    res = run_case(name)
    for what, a, b in zip(("out", "lse", "dq", "dk", "dv"), res[True], res[False]):
        assert torch.equal(a, b), what


@pytest.mark.parametrize("name", list(CASES))
def test_rows_past_the_length_are_zero(name):
    res = run_case(name)
    n = _inputs(name)[4][0]
    for b, nb in enumerate(n.tolist()):
        for x in res[True]:
            assert torch.all(x[b, :, nb:] == 0)


def test_group_ranges_skip_something():
    """At band 50 every warp meets 5 of the 8 key groups of its block's two
    resident tiles; bands up to 64 fit one chunk, band 65 needs a second."""
    assert query_warp_groups(128, 50) == (4, 8)
    assert query_warp_groups(176, 50) == (7, 11)
    assert query_warp_groups(16, 50) == (0, 1)
    assert key_warp_groups(64, 50, 267) == (4, 8)
    assert key_warp_groups(240, 50, 267) == (15, 16)  # cut by the length
    for band, want in ((30, 3), (50, 5), (64, 5), (65, 6), (128, 9)):
        lo, hi = query_warp_groups(512, band)
        assert hi - lo + 1 == want == -(-band // GROUP) + 1
        assert len(chunks_of(lo, hi, 0, 35, True)) == (1 if band <= 64 else 2)
        klo, khi = key_warp_groups(512, band, 2000)
        assert khi - klo + 1 == want
    # visiting them all: the same chunks, with others before and after
    assert chunks_of(4, 8, 4, 11, False) == [[4, 5, 6, 7, 8], [9, 10, 11]]
    assert chunks_of(7, 11, 4, 11, False) == [[4, 5, 6], [7, 8, 9, 10, 11]]


def test_one_bf16_rounding_costs_part_of_the_bound():
    """What the hi + lo split and D from the f32 weights buy at the training
    shape with hash dropout 0.1: one bf16 rounding of W o M before the PV
    product, or D = rowsum(dO o O) over the bf16 output, each moves the
    result further from the f32 plain version than the kernels' choice."""
    name = "train-band50-dropout0.1"
    qb, kb, vb, gb, args = _inputs(name)
    res = run_case(name)
    out, lse = res[True][:2]

    def err(got, want):
        return (got.float() - want).abs().max().item()

    split = err(out, res["want"])
    rounded = err(emulate_forward(qb, kb, vb, *args, split=False)[0], res["want"])
    # the output's own rounding is there either way; the operand's adds to it
    mean_split = (out.float() - res["want"]).abs().mean().item()
    mean_rounded = (emulate_forward(qb, kb, vb, *args, split=False)[0].float()
                    - res["want"]).abs().mean().item()
    assert rounded >= split and mean_rounded > 1.05 * mean_split

    from_weights = [err(a, w) for a, w in zip(res[True][2:], res["want_grads"])]
    from_output = [
        err(a, w) for a, w in zip(
            emulate_backward(qb, kb, vb, lse, *args, gb, d_from_output=out),
            res["want_grads"])
    ]
    assert from_weights[2] == from_output[2]  # dV does not read D
    assert max(from_output[:2]) > max(from_weights[:2])
    assert max(from_weights) <= BOUND


# -- the wrapper: one validation, in the forward ----------------------------------


def _card_branch(monkeypatch):
    """Run the card branch of the autograd Function's forward on CPU
    tensors: the device check is taken out and the launches are recorded
    and answered by the plain versions (``calls.k1.stats``: what K1 was
    handed for its row statistics)."""
    calls = type("Calls", (list,), {})()
    monkeypatch.setattr(fa, "_check_tensors", lambda q, k, v: None)

    def fake_k1(q, k, v, q_len, k_len, seed, scale, rate, causal, band, stats=None,
                out_lo=None):
        calls.append("K1")
        fake_k1.stats = stats
        return fa.attention_reference(q, k, v, q_len, k_len, seed, scale, rate, causal, band)

    def fake_k6(q, k, v, n, seed, scale, rate, band, lse=None):
        calls.append("K6")
        return fa.banded_attention_reference(q, k, v, n, seed, scale, rate, band)

    def fake_bwd(*args):
        calls.append("backward")
        return None

    calls.k1 = fake_k1
    monkeypatch.setattr(fa, "_launch", fake_k1)
    monkeypatch.setattr(fa, "banded_attention_kernel", fake_k6)
    monkeypatch.setattr(fa, "_launch_backward", fake_bwd)
    monkeypatch.setattr(fa, "_launch_banded_backward", fake_bwd)
    return calls


def _keyless_inputs():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 40, 32, generator=g) for _ in range(3))
    q_len = torch.tensor([40, 40], dtype=torch.int32)
    k_len = torch.tensor([40, 9], dtype=torch.int32)  # rows 30.. of 1 see no key
    return q, k, v, q_len, k_len


@pytest.mark.parametrize("needs_grad", [True, False])
def test_forward_saves_row_stats_and_checks_only_key_lengths(monkeypatch, needs_grad):
    """Rows that see no key take the full-tile route like any other, with a
    gradient or without: K1 is handed a (B, H, Tq, 2) f32 tensor for each
    row's max and log-sum exactly when a gradient is needed, the backward
    gets it with the int32 lengths, and the one check is k_length >= 1."""
    calls = _card_branch(monkeypatch)
    q, k, v, q_len, k_len = _keyless_inputs()
    args = (q, k, v, q_len, k_len, 5, 0.25, 0.0, True, 20, False, needs_grad)
    out, saved = fa._forward_kernels(*args)
    assert calls == ["K1"] and out.shape == q.shape
    stats = calls.k1.stats
    if needs_grad:
        assert stats.shape == (2, 2, 40, 2) and stats.dtype == torch.float32
        assert saved[6] is stats and saved[5] is out
        assert saved[3].dtype == saved[4].dtype == torch.int32
    else:
        assert stats is None and saved is None
    calls.clear()
    with pytest.raises(ValueError, match="every k_length must be >= 1"):
        fa._forward_kernels(q, k, v, q_len, k_len * 0, 5, 0.25, 0.0, True, 20, False,
                            needs_grad)
    assert calls == []


def test_windowed_forward_has_no_refusal(monkeypatch):
    """On the windowed route the one length masks keys and zeroes rows (no
    row without a key), and K6 keeps its single log-sum-exp per row."""
    calls = _card_branch(monkeypatch)
    q, k, v, q_len, k_len = _keyless_inputs()
    out, saved = fa._forward_kernels(q, k, v, q_len, k_len, 5, 0.25, 0.0, True, 20, True, True)
    assert calls == ["K6"] and saved[5] is None  # K7 takes no forward output
    assert saved[6].shape == q.shape[:3]
    with pytest.raises(ValueError, match="every k_length must be >= 1"):
        fa._forward_kernels(q, k, v, q_len, k_len * 0, 5, 0.25, 0.0, True, 20, True, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forward_keeps_the_output_residual_for_k2_in_bf16_only(monkeypatch, dtype):
    """K2 takes D from a bf16 output plus what its rounding took away: the
    forward has K1 write that beside the output when a gradient is needed;
    f32, K6/K7 and a call without a gradient keep none."""
    _card_branch(monkeypatch)
    q, k, v, q_len, _ = _keyless_inputs()
    q, k, v = (x.to(dtype) for x in (q, k, v))
    args = (q, k, v, q_len, q_len, 5, 0.25, 0.0, True, 20)
    _, saved = fa._forward_kernels(*args, False, True)
    if dtype == torch.bfloat16:
        assert saved[7].shape == q.shape and saved[7].dtype == dtype
    else:
        assert saved[7] is None
    assert fa._forward_kernels(*args, True, True)[1][7] is None
    assert fa._forward_kernels(*args, False, False)[1] is None
    with pytest.raises(ValueError, match="out_lo must be like q"):
        fa._residual_ptr(q.bfloat16(), q.bfloat16()[:, :, :5])


def test_public_backward_functions_still_validate(monkeypatch):
    q, k, v, q_len, k_len = _keyless_inputs()
    lse = torch.zeros(q.shape[:3])
    stats = torch.zeros(*q.shape[:3], 2)
    # CPU tensors: refused by the device check, nothing launched
    with pytest.raises(ValueError, match="unsupported device"):
        fa.attention_backward_kernel(q, k, v, q, stats, q_len, k_len, 5, 0.25, 0.0, True, 20, q)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.banded_attention_backward_kernel(q, k, v, lse, k_len, 5, 0.25, 0.0, 20, q)
    # past the device check: the length check before a launch; rows that see
    # no key go to K2 like any other
    calls = _card_branch(monkeypatch)
    for zero in (
        lambda: fa.attention_backward_kernel(
            q, k, v, q, stats, q_len, k_len * 0, 5, 0.25, 0.0, True, 20, q),
        lambda: fa.banded_attention_backward_kernel(q, k, v, lse, k_len * 0, 5, 0.25, 0.0, 20, q),
    ):
        with pytest.raises(ValueError, match="every k_length must be >= 1"):
            zero()
    assert calls == []
    fa.attention_backward_kernel(q, k, v, q, stats, q_len, k_len, 5, 0.25, 0.0, True, 20, q)
    fa.banded_attention_backward_kernel(q, k, v, lse, k_len, 5, 0.25, 0.0, 20, q)
    assert calls == ["backward", "backward"]


def test_backward_launches_check_their_tensors():
    q, k, v, _, _ = _keyless_inputs()
    with pytest.raises(ValueError, match=r"row values must be \(2, 2, 40\) f32"):
        fa._check_backward_tensors(q, torch.zeros(2, 2, 39), q)
    with pytest.raises(ValueError, match=r"row values must be \(2, 2, 40, 2\) f32"):
        fa._check_backward_tensors(q, torch.zeros(q.shape[:3]), q, q, per_row=2)
    fa._check_backward_tensors(q, fa.row_stats_like(q), q, q, per_row=2)
    with pytest.raises(ValueError, match="out/dout shapes"):
        fa._check_backward_tensors(q, torch.zeros(q.shape[:3]), q[:, :, :5])
    dout = fa._check_backward_tensors(q, torch.zeros(q.shape[:3]), q.double(), q)
    assert dout.dtype == q.dtype and dout.is_contiguous()


def test_resident_window_limit():
    """The limit lives in the CUDA source alone: an entry point answers a
    wider window with minus the tiles it holds, before any launch, and the
    wrapper turns that into a ValueError that names them; any other code
    that is not 0 stays a launch error."""
    q = torch.empty(1, 1, 3000, 64, dtype=torch.bfloat16)
    fa._check_banded(0, "asr_banded_attention_fwd", q, 704)
    with pytest.raises(ValueError, match="band 705 over 3000 frames needs more than 12 resident"):
        fa._check_banded(-12, "asr_banded_attention_fwd", q, 705)
    with pytest.raises(RuntimeError, match="asr_banded_attention_bwd: CUDA error 1"):
        fa._check_banded(1, "asr_banded_attention_bwd", q, 50)
