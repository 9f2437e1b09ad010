"""CPU rehearsal of the redesigned CTC forward kernel (K3,
``ops/csrc/ctc.cu``): a plain torch emulation of its two launches, held
against the plain version ``ctc_alpha_reference`` and against the JAX
package's ``ctc_loss_pallas`` (interpret mode).

What the emulation keeps of the kernel:
- the row pass, a warp per (b, t) row: the row cut as ``row_parts`` cuts it
  (scalars up to the first 16-byte boundary, whole 16-byte vectors, the
  rest; the logits start on a 16-byte boundary, so row r is off it by r C
  elements), lane l taking elements l, l + 32, ... of each part, an online
  (max, sum) per lane (the sum rescaled when the max grows, a vector's
  terms added in order), the 32 lanes merged by the xor butterfly over 16,
  8, 4, 2, 1, then lse = max + log(sum);
- the (B, T, S) emission table, written for t < max(len, 1) only (the
  other rows are NaN here: the recursion must not read them);
- the recursion over a shared buffer of S + 2 positions with two log-zero
  pads in front, position s reading s, s - 1 and s - 2 of the step before,
  the skip term log-zero where the mask is off (a select, no branch);
- the loss from the last two states, last = min(2 label_len, S - 1).
For bf16 logits the kernel takes each term of a lane's sum as 2^(x log2 e
- max log2 e), one fused multiply-add and one ex2, and its log and
log-add-exp are the hardware's approximations too (1e-7 from these); for
f32 logits it takes expf, logf and log1pf. Here they are torch's float32
exp, log and logaddexp.

Tolerances, the bounds ``chip_smoke.py`` holds the kernel to on the card:
loss rtol 1e-4 (also against JAX), lse 1e-5 abs, alpha on rows t < len
within 1e-4 of max(1, |plain|) where the plain version reaches the cell,
log-zero on both sides where it does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.ops.ctc_pallas import ctc_loss_pallas as jax_ctc_loss_pallas
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel
from asr_chinese_e2e_tpu_torch.ops.ctc import BIG_NEG, extend_labels

LOSS_RTOL = 1e-4
LSE_ABS = 1e-5
ALPHA_REL = 1e-4
LOG_ZERO = -1e29
FLT_MAX = torch.finfo(torch.float32).max


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _online(m, total, v, exists):
    """One update of the lanes' (max, sum) by the values ``v`` (..., 32, k),
    a vector's k terms added in order, where ``exists``."""
    mn = torch.maximum(m, v.max(-1).values)
    add = torch.zeros_like(total)
    for k in range(v.shape[-1]):
        add = add + torch.exp(v[..., k] - mn)
    new_total = total * torch.exp(m - mn) + add
    return torch.where(exists, mn, m), torch.where(exists, new_total, total)


def emulate_row_lse(x, row0):
    """lse of the rows ``x`` (R, C) as one warp a row computes it; row i of
    ``x`` is row ``row0 + i`` of the logits."""
    n_rows, c = x.shape
    vw = 16 // x.element_size()
    x32 = x.float()
    lanes = torch.arange(32)
    out = torch.empty(n_rows)
    for mis in range(vw):
        sel = torch.tensor([(row0 + i) * c % vw == mis for i in range(n_rows)])
        if not bool(sel.any()):
            continue
        xs = x32[sel]
        r = xs.shape[0]
        head = min(c, (vw - mis) % vw)
        n_vec = (c - head) // vw
        m = torch.full((r, 32), -FLT_MAX)
        total = torch.zeros(r, 32)
        # the scalars before the first boundary: lane l takes element l
        pad = torch.zeros(r, 32)
        pad[:, :head] = xs[:, :head]
        m, total = _online(m, total, pad[..., None], (lanes < head)[None, :])
        # the vectors: lane l takes vectors l, l + 32, ...
        vecs = xs[:, head : head + n_vec * vw].reshape(r, n_vec, vw)
        for k in range(0, n_vec, 32):
            chunk = torch.zeros(r, 32, vw)
            n = min(32, n_vec - k)
            chunk[:, :n] = vecs[:, k : k + n]
            m, total = _online(m, total, chunk, (lanes < n)[None, :])
        # the rest: lane l takes element head + n_vec V + l
        rest = c - head - n_vec * vw
        pad = torch.zeros(r, 32)
        pad[:, :rest] = xs[:, c - rest :]
        m, total = _online(m, total, pad[..., None], (lanes < rest)[None, :])
        for off in (16, 8, 4, 2, 1):
            mo, so = m[:, lanes ^ off], total[:, lanes ^ off]
            mn = torch.maximum(m, mo)
            total = total * torch.exp(m - mn) + so * torch.exp(mo - mn)
            m = mn
        out[sel] = m[:, 0] + torch.log(total[:, 0])
    return out


def emulate_row_pass(logits, ext, lens):
    """(lse (B, T), emission table (B, T, S)) as ctc_emission_rows_kernel
    writes them: the table's rows t >= max(len, 1) stay unwritten (NaN)."""
    bsz, t_max, c = logits.shape
    lse = emulate_row_lse(logits.reshape(bsz * t_max, c), 0).reshape(bsz, t_max)
    emit = logits.float().gather(2, ext[:, None, :].expand(-1, t_max, -1)) - lse[..., None]
    n = lens.long().clamp(max=t_max).clamp(min=1)
    written = torch.arange(t_max)[None, :, None] < n[:, None, None]
    return lse, torch.where(written, emit, torch.full_like(emit, float("nan")))


def emulate_recursion(emit, ext, lens, lab_lens, blank=0):
    """(loss (B,), alpha (B, T, S)) as ctc_alpha_recursion_kernel writes
    them: the rows t >= max(len, 1) stay unwritten (NaN)."""
    bsz, t_max, s = emit.shape
    big = torch.tensor(BIG_NEG)
    two_back = torch.cat([torch.full((bsz, 2), -1, dtype=ext.dtype), ext[:, :-2]], 1)
    skip = (torch.arange(s)[None, :] >= 2) & (ext != blank) & (ext != two_back)
    n = lens.long().clamp(max=t_max).clamp(min=1)
    pads = torch.full((bsz, 2), BIG_NEG)
    alpha = torch.full((bsz, t_max, s), float("nan"))
    val = torch.where(torch.arange(s)[None, :] <= 1, emit[:, 0], big)
    alpha[:, 0] = val
    for t in range(1, t_max):
        running = (t < n)[:, None]
        if not bool(running.any()):
            break
        buf = torch.cat([pads, val], 1)  # position s + 2 holds state s
        s1, s2 = buf[:, 1 : s + 1].contiguous(), buf[:, :s].contiguous()
        e = torch.where(running, emit[:, t], torch.zeros(()))  # the ring holds no row t >= n
        new = torch.logaddexp(torch.logaddexp(val, s1), torch.where(skip, s2, big)) + e
        val = torch.where(running, new, val)
        alpha[:, t] = torch.where(running, new, alpha[:, t])
    last = (2 * lab_lens.long()).clamp(max=s - 1)
    a_last = val.gather(1, last[:, None])[:, 0]
    a_prev = val.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(a_last, torch.where(last > 0, a_prev, big))
    return loss, alpha


def make_case(seed, B=4, T=20, L=6, C=10, lens=None, label_lens=None, dtype=torch.float32):
    """The cases of ``tests/test_torch_ctc.py``: numpy-seeded logits and
    labels, 0-padded."""
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, T, C) * 2.0).astype(np.float32)
    logit_lens = np.asarray(lens if lens is not None else [T] * B, np.int32)
    ll = np.asarray(label_lens if label_lens is not None else [L] * B, np.int32)
    labels = rng.randint(1, C, size=(B, L)).astype(np.int32)
    for b in range(B):
        labels[b, ll[b]:] = 0
    x = torch.from_numpy(logits).to(dtype)
    return x, torch.from_numpy(logit_lens), torch.from_numpy(labels), torch.from_numpy(ll)


CASES = {
    "full": dict(seed=0),
    "ragged": dict(seed=0, lens=[20, 17, 12, 9], label_lens=[6, 4, 3, 1]),
    "label-lengths": dict(seed=0, lens=[20] * 4, label_lens=[6, 6, 1, 2]),
    "grad-ragged": dict(seed=1, lens=[20, 15, 20, 11], label_lens=[5, 3, 6, 2]),
    "odd-shapes": dict(seed=3, B=3, T=7, L=2, C=5),
    "empty-label": dict(seed=5, lens=[20, 13, 20, 8], label_lens=[6, 0, 2, 0]),
    "label-longer-than-logits": dict(seed=6, B=2, T=8, L=6, lens=[8, 3], label_lens=[6, 5]),
    "len-1": dict(seed=7, B=3, T=9, L=3, lens=[1, 9, 4], label_lens=[1, 3, 0]),
    # rows of C = 601 (not a multiple of 8) and of the flagship's 4233 classes
    "C601": dict(seed=8, B=3, T=12, L=5, C=601, lens=[12, 10, 7], label_lens=[5, 2, 4]),
    "C4233": dict(seed=9, B=2, T=10, L=4, C=4233, lens=[10, 6], label_lens=[4, 3]),
}
DTYPES = [torch.float32, torch.bfloat16]


def _check_against_plain(lse, loss, alpha, want, lens):
    want_loss, want_alpha, want_lse = want
    assert (lse - want_lse).abs().max().item() <= LSE_ABS
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=LOSS_RTOL)
    t_max = alpha.shape[1]
    rows = (torch.arange(t_max)[None, :] < lens.long().clamp(min=1)[:, None])[..., None]
    rows = rows.expand_as(alpha)
    reach = rows & (want_alpha > LOG_ZERO)
    assert bool(torch.isfinite(alpha[rows]).all())
    rel = (alpha - want_alpha).abs() / want_alpha.abs().clamp(min=1.0)
    assert rel[reach].max().item() <= ALPHA_REL
    assert bool((alpha[rows & ~reach] <= LOG_ZERO).all())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_matches_the_plain_version(case, dtype):
    """The two launches as the kernel does them give the plain version's
    lse, loss and alpha (rows t < len) within the card's bounds, and read no
    row of the emission table that the row pass left unwritten."""
    logits, lens, labels, lab_lens = make_case(**CASES[case], dtype=dtype)
    ext = extend_labels(labels.long())
    want = ctc_kernel.ctc_alpha_reference(logits, ext, lens, lab_lens)
    lse, emit = emulate_row_pass(logits, ext, lens)
    loss, alpha = emulate_recursion(emit, ext, lens, lab_lens)
    _check_against_plain(lse, loss, alpha, want, lens)


@pytest.mark.parametrize("case", list(CASES))
def test_recursion_on_the_plain_emissions_is_the_plain_recursion(case):
    """Given the plain version's log-sum-exp, the buffer recursion (pads,
    s - 1 and s - 2 by position, the skip as a select) gives the plain
    alpha and loss bit for bit: logaddexp with log-zero is exact."""
    logits, lens, labels, lab_lens = make_case(**CASES[case])
    ext = extend_labels(labels.long())
    want_loss, want_alpha, want_lse = ctc_kernel.ctc_alpha_reference(
        logits, ext, lens, lab_lens)
    emit = logits.gather(2, ext[:, None, :].expand(-1, logits.shape[1], -1)) - want_lse[..., None]
    loss, alpha = emulate_recursion(emit, ext, lens, lab_lens)
    rows = torch.arange(alpha.shape[1])[None, :] < lens.long().clamp(min=1)[:, None]
    assert torch.equal(alpha[rows], want_alpha[rows])
    assert torch.equal(loss, want_loss)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [5, 10, 601, 4233])
def test_row_pass_is_the_log_sum_exp(c, dtype):
    """The warp's order (misaligned head, vectors, tail, online rescaling,
    butterfly) gives torch's log-sum-exp within 1e-5, for every
    misalignment a row can have."""
    g = torch.Generator().manual_seed(c)
    x = (torch.randn(24, c, generator=g) * 4.0 + torch.linspace(-30, 30, 24)[:, None]).to(dtype)
    got = emulate_row_lse(x, row0=0)
    want = torch.logsumexp(x.float(), -1)
    assert (got - want).abs().max().item() <= LSE_ABS


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "case", ["ragged", "empty-label", "label-longer-than-logits", "len-1", "C601"])
def test_emulation_matches_jax(case, dtype):
    """The loss against ``ctc_loss_pallas`` in Pallas interpret mode, rtol
    1e-4, on the same (bf16-rounded where bf16) logits."""
    logits, lens, labels, lab_lens = make_case(**CASES[case], dtype=dtype)
    ext = extend_labels(labels.long())
    _, emit = emulate_row_pass(logits, ext, lens)
    loss, _ = emulate_recursion(emit, ext, lens, lab_lens)
    want = np.asarray(jax_ctc_loss_pallas(
        jnp.asarray(logits.float().numpy()), jnp.asarray(lens.numpy()),
        jnp.asarray(labels.numpy()), jnp.asarray(lab_lens.numpy())))
    np.testing.assert_allclose(loss.numpy(), want, rtol=LOSS_RTOL)
