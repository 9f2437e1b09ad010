"""CPU rehearsal of the tensor-core attention kernels (K1 and K2 for bf16
inputs, ``ops/csrc/fused_attention_{fwd,bwd}.cu``): a plain torch emulation
of their arithmetic with their rounding points, held against the f32 plain
versions within the bounds the kernels are held to on the card.

What the emulation keeps of the kernels: bf16 q, k, v and dO; f32 scores;
the online (max, sum) softmax over key tiles of 64 per block of 64 query
rows; the weights times the keep mask (and, in the backward, dS) split into
hi + lo bf16 parts before each product that takes them as an operand; D =
rowsum(dO o O) from the bf16-rounded output; W recomputed from the row
log-sum-exp; outputs rounded to bf16; and the tile ranges of
``mma.cuh::key_tile_range`` and ``fused_attention_bwd.cu::
query_tile_range``, whose skips must leave every result bit-identical.
Those two ranges are mirrored here by hand (``key_tile_range`` and
``query_tile_range`` below) and must change together with the CUDA
functions; the kernels' own ranges are held to the plain versions on the
card, by ``chip_smoke.py`` at the same masks.
A product of bf16 operands with f32 accumulation is an f32 matmul of the
same values (only the order of the sums differs).

Also the bound figures ``chip_smoke.py`` prints beside K1 and K2.
"""

import functools
import math

import pytest
import torch

import chip_smoke
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa

TILE = 64  # ATT_TILE: rows of a query block and of a key tile
NEG_BIAS = -1e9
BOUND = 2e-2  # the card's bf16 bound, absolute, against the f32 plain version


def split_matmul(a, b):
    """(hi + lo) @ b with hi = bf16(a), lo = bf16(a - hi): the two products
    the kernels make for an f32 operand."""
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    return hi @ b + lo @ b


def visible(i, j, kn, causal, band):
    keep = j < kn
    if causal:
        keep = keep & (j <= i)
        if band > 0:
            keep = keep & (i - j <= band)
    elif band > 0:
        keep = keep & ((i - j).abs() <= band)
    return keep


def key_tile_range(i0, i_last, tk, kn, causal, band):
    n_tiles = -(-tk // TILE)
    if band > 0 and i_last > kn - 1 + band:
        return 0, n_tiles
    last = min(tk, kn)
    if causal:
        last = min(last, i_last + 1)
    elif band > 0:
        last = min(last, i_last + band + 1)
    lo = max(0, i0 - band) // TILE if band > 0 else 0
    return lo, -(-last // TILE)


def query_tile_range(j0, qn, kn, causal, band):
    """Every query row below qn sees a key: the backward's precondition."""
    first, last = 0, qn
    if j0 >= kn:
        last = 0
    else:
        j_last = min(j0 + TILE, kn) - 1
        if causal:
            first = j0
        elif band > 0:
            first = max(0, j0 - band)
        if band > 0:
            last = min(qn, j_last + band + 1)
    return first // TILE, -(-last // TILE)


def emulate_forward(q, k, v, q_len, k_len, seed, scale, rate, causal, band, skip):
    """(out bf16, lse f32) as attention_fwd_mma_kernel computes them."""
    bsz, heads, tq, d = q.shape
    tk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(bsz, heads, tq, d)
    lse = torch.zeros(bsz, heads, tq)
    keep = fa.keep_mask_reference(seed, bsz, heads, tq, tk, rate) if rate > 0 else None
    for b in range(bsz):
        qn, kn = int(q_len[b]), min(int(k_len[b]), tk)
        for i0 in range(0, tq, TILE):
            i1 = min(i0 + TILE, tq)
            t_lo, t_hi = 0, -(-tk // TILE)
            if skip:
                t_lo, t_hi = key_tile_range(i0, i1 - 1, tk, kn, causal, band)
            rows = torch.arange(i0, i1)[:, None]
            m = torch.full((heads, i1 - i0), -math.inf)
            l = torch.zeros(heads, i1 - i0)
            o = torch.zeros(heads, i1 - i0, d)
            for t in range(t_lo, t_hi):
                j0, j1 = t * TILE, min((t + 1) * TILE, tk)
                cols = torch.arange(j0, j1)[None, :]
                s = (qf[b, :, i0:i1] @ kf[b, :, j0:j1].transpose(-1, -2)) * scale
                s = s + torch.where(visible(rows, cols, kn, causal, band), 0.0, NEG_BIAS)
                m_new = torch.maximum(m, s.max(-1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                if keep is not None:
                    p = p * keep[b, :, i0:i1, j0:j1]
                o = o * corr[..., None] + split_matmul(p, vf[b, :, j0:j1])
                m = m_new
            norm = torch.where(rows[:, 0] < qn, 1.0 / l, torch.zeros(()))
            out[b, :, i0:i1] = o * norm[..., None]
            lse[b, :, i0:i1] = m + torch.log(l)
    return out.to(torch.bfloat16), lse


def emulate_backward(
    q, k, v, out, lse, q_len, k_len, seed, scale, rate, causal, band, dout, skip
):
    """(dq, dk, dv) bf16 as the D pass, attention_bwd_dkdv_mma_kernel and
    attention_bwd_dq_mma_kernel compute them."""
    bsz, heads, tq, d = q.shape
    tk = k.shape[2]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    delta = (out.float() * gf).sum(-1)
    keep = fa.keep_mask_reference(seed, bsz, heads, tq, tk, rate) if rate > 0 else None
    dq = torch.zeros(bsz, heads, tq, d)
    dk = torch.zeros(bsz, heads, tk, d)
    dv = torch.zeros(bsz, heads, tk, d)

    def tile(b, i0, i1, j0, j1, qn, kn):
        """(W o M, dS) of one (query tile, key tile), f32."""
        rows = torch.arange(i0, i1)[:, None]
        cols = torch.arange(j0, j1)[None, :]
        s = (qf[b, :, i0:i1] @ kf[b, :, j0:j1].transpose(-1, -2)) * scale
        s = s + torch.where(visible(rows, cols, kn, causal, band), 0.0, NEG_BIAS)
        w = torch.exp(s - lse[b, :, i0:i1, None]) * (rows < qn)
        dp = gf[b, :, i0:i1] @ vf[b, :, j0:j1].transpose(-1, -2)
        kp = keep[b, :, i0:i1, j0:j1] if keep is not None else 1.0
        return w * kp, w * (dp * kp - delta[b, :, i0:i1, None])

    n_key_tiles = -(-tk // TILE)
    for b in range(bsz):
        qn, kn = min(int(q_len[b]), tq), min(int(k_len[b]), tk)
        for j0 in range(0, tk, TILE):  # the dK / dV pass
            j1 = min(j0 + TILE, tk)
            t_lo, t_hi = 0, -(-qn // TILE)
            if skip:
                t_lo, t_hi = query_tile_range(j0, qn, kn, causal, band)
            for t in range(t_lo, t_hi):
                i0, i1 = t * TILE, min((t + 1) * TILE, tq)
                wm, ds = tile(b, i0, i1, j0, j1, qn, kn)
                dv[b, :, j0:j1] += split_matmul(wm.transpose(-1, -2), gf[b, :, i0:i1])
                dk[b, :, j0:j1] += split_matmul(ds.transpose(-1, -2), qf[b, :, i0:i1])
        for i0 in range(0, min(tq, qn), TILE):  # the dQ pass
            i1 = min(i0 + TILE, tq)
            t_lo, t_hi = 0, n_key_tiles
            if skip:
                t_lo, t_hi = key_tile_range(i0, min(i1, qn) - 1, tk, kn, causal, band)
            for t in range(t_lo, t_hi):
                j0, j1 = t * TILE, min((t + 1) * TILE, tk)
                _, ds = tile(b, i0, i1, j0, j1, qn, kn)
                dq[b, :, i0:i1] += split_matmul(ds, kf[b, :, j0:j1])
    bf16 = torch.bfloat16
    return (dq * scale).to(bf16), (dk * scale).to(bf16), dv.to(bf16)


SHAPES = {
    # name: (batch, tq, tk, head dim)
    "square": (4, 267, 267, 64),
    "rectangular": (2, 21, 267, 64),
}
MASKS = {
    # name: (causal, band)
    "full": (False, 0),
    "causal": (True, 0),
    "band50": (False, 50),
    "causal-band50": (True, 50),
}
CASES = [
    (shape, mask, rate) for shape in SHAPES for mask in MASKS for rate in (0.0, 0.1)
] + [
    ("head-dim-32", "full", 0.1), ("single-query", "full", 0.0),
    ("short-keys", "causal-band50", 0.1), ("short-keys", "band50", 0.1),
]
SHAPES["head-dim-32"] = (4, 267, 267, 32)
SHAPES["single-query"] = (4, 1, 267, 64)
# the keys end a band before the queries do: the last rows see one key
SHAPES["short-keys"] = (4, 267, 267, 64)


@functools.lru_cache(maxsize=None)
def run_case(shape, mask, rate):
    """Inputs as ``chip_smoke._attn_inputs`` makes them, through the
    emulation with and without tile skipping and through the f32 plain
    versions."""
    bsz, tq, tk, d = SHAPES[shape]
    causal, band = MASKS[mask]
    seed = 100 + CASES.index((shape, mask, rate))
    q, k, v, q_len, k_len = chip_smoke._attn_inputs(bsz, 8, tq, tk, d, "cpu", seed)
    if shape == "short-keys":
        k_len = chip_smoke.short_keys(q_len, band)
        assert int(fa.keyless_row_gap(q_len, k_len, tq, tk).max()) == band
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed))
    qb, kb, vb, gb = (x.to(torch.bfloat16) for x in (q, k, v, g))
    args = (q_len, k_len, 777, d**-0.5, rate, causal, band)
    res = {}
    for skip in (True, False):
        out, lse = emulate_forward(qb, kb, vb, *args, skip)
        grads = emulate_backward(qb, kb, vb, out, lse, *args, gb, skip)
        res[skip] = (out, lse, *grads)
    plain = (qb.float(), kb.float(), vb.float())
    res["want"] = fa.attention_reference(*plain, *args)
    res["want_grads"] = fa.attention_backward_reference(*plain, *args, gb.float())
    return res


@pytest.mark.parametrize("shape,mask,rate", CASES)
def test_forward_rounding_within_card_bound(shape, mask, rate):
    res = run_case(shape, mask, rate)
    out = res[True][0]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    assert (out.float() - res["want"]).abs().max().item() <= BOUND


@pytest.mark.parametrize("shape,mask,rate", CASES)
def test_backward_rounding_within_card_bound(shape, mask, rate):
    res = run_case(shape, mask, rate)
    for name, got, want in zip(("dq", "dk", "dv"), res[True][2:], res["want_grads"]):
        assert torch.isfinite(got.float()).all(), name
        assert (got.float() - want).abs().max().item() <= BOUND, name


@pytest.mark.parametrize("shape,mask,rate", CASES)
def test_tile_skipping_is_bit_identical(shape, mask, rate):
    res = run_case(shape, mask, rate)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), res[True], res[False]):
        assert torch.equal(a, b), name


def test_tile_ranges_skip_something():
    """The ranges are not trivially everything: a causal-band block in the
    middle meets two key tiles of five, a key block past the key length no
    query tile."""
    assert key_tile_range(128, 191, 267, 267, True, 50) == (1, 3)
    assert key_tile_range(128, 191, 267, 267, False, 50) == (1, 4)
    assert key_tile_range(128, 191, 267, 100, False, 0) == (0, 2)
    assert key_tile_range(192, 255, 267, 100, True, 50) == (0, 5)  # rows see no key
    assert query_tile_range(128, 267, 100, False, 0) == (0, 0)
    assert query_tile_range(64, 267, 267, True, 50) == (1, 3)
    assert query_tile_range(192, 267, 217, True, 50) == (3, 5)  # keys 192-216, short keys


def test_keyless_row_gap_marks_rows_without_a_key():
    """The backward wrapper refuses lengths whose gap exceeds the band: with
    band 20 the utterances with 100, 30 and 1 keys under 267 query rows
    have rows that see no key, and the plain forward gives those rows the
    mean of all Tk values."""
    q_len = torch.tensor([267, 267, 267, 300], dtype=torch.int32)
    k_len = torch.tensor([267, 100, 247, 1], dtype=torch.int32)
    gap = fa.keyless_row_gap(q_len, k_len, 267, 267)
    assert gap.tolist() == [0, 167, 20, 266]
    assert (gap > 20).tolist() == [False, True, False, True]
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 2, 267, 32, generator=g) for _ in range(3))
    out = fa.attention_reference(q, k, v, q_len, k_len, 0, 32**-0.5, 0.0, True, 20)
    assert torch.allclose(out[1, :, 121], v[1].mean(1), atol=1e-5)  # 121 - 20 > 99
    assert not torch.allclose(out[1, :, 119], v[1].mean(1), atol=1e-2)


def test_bounds_at_the_training_shape():
    """K1 moves 70.0 MB and K2 140.0 MB at (64, 8, 267, 64) bf16, and both
    are bound by those bytes: 20.9 and 41.8 us at 3.35 TB/s, against 9.4
    and 23.6 us of tensor-core time for 9.3 and 23.4 GFLOP."""
    fwd = chip_smoke.attention_fwd_bound(64, 8, 267, 267, 64)
    bwd = chip_smoke.attention_bwd_bound(64, 8, 267, 267, 64)
    assert fwd["bytes"] / 1e6 == pytest.approx(70.0, abs=0.05)
    assert bwd["bytes"] / 1e6 == pytest.approx(140.0, abs=0.05)
    assert fwd["flops"] / 1e9 == pytest.approx(9.34, abs=0.01)
    assert bwd["flops"] / 1e9 == pytest.approx(23.36, abs=0.01)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes"
    assert fwd["bound_ms"] == pytest.approx(70.0e6 / 3.35e12 * 1e3, rel=1e-3)
    assert bwd["bound_ms"] == pytest.approx(140.0e6 / 3.35e12 * 1e3, rel=1e-3)
    # f32 inputs run on FMAs: operations bound them
    assert chip_smoke.attention_fwd_bound(64, 8, 267, 267, 64, 4)["bound_by"] == "operations"


@pytest.mark.parametrize("name", ["fbank", "ctc_alpha", "ctc_beta", "banded"])
def test_other_bounds_match_the_hand_reckoning(name):
    if name == "fbank":  # 49.2 MB; an FFT and sparse mel filters need ~0.5 GFLOP
        got = chip_smoke.fbank_bound(64, 128000)
        assert got["bound_by"] == "bytes"
        assert got["bytes"] / 1e6 == pytest.approx(49.2, abs=0.1)
        assert 0.3 < got["flops"] / 1e9 < 0.8
        assert got["bound_ms"] == pytest.approx(0.0147, abs=0.0002)
    elif name == "ctc_alpha":  # ~149 MB
        got = chip_smoke.ctc_alpha_bound(64, 267, 4233, 65)
        assert got["bound_by"] == "bytes" and got["bytes"] / 1e6 == pytest.approx(149, abs=1)
    elif name == "ctc_beta":  # ~294 MB
        got = chip_smoke.ctc_beta_bound(64, 267, 4233, 65)
        assert got["bound_by"] == "bytes" and got["bytes"] / 1e6 == pytest.approx(294, abs=1)
    else:  # the window moves K1's bytes and multiplies fewer pairs
        pairs = chip_smoke.band_pairs([267] * 64, 8, 50)
        full = chip_smoke.attention_fwd_bound(64, 8, 267, 267, 64)
        got = chip_smoke.attention_fwd_bound(64, 8, 267, 267, 64, pairs=pairs)
        assert got["bytes"] == full["bytes"] and got["flops"] < 0.4 * full["flops"]
        # K7 takes no forward output: seven tensors of 17.5 MB, not K2's eight
        bwd = chip_smoke.banded_attention_bwd_bound(64, 8, 267, 64, pairs=pairs)
        assert bwd["bound_by"] == "bytes"
        assert bwd["bytes"] / 1e6 == pytest.approx(122.5, abs=0.05)
        assert bwd["bound_ms"] == pytest.approx(0.0366, abs=0.0001)
