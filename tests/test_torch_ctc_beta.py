"""CPU rehearsal of the redesigned CTC backward kernel (K4,
``ops/csrc/ctc.cu``): a plain torch emulation of its two launches, held
against the plain version ``ctc_beta_reference`` bit for bit and against
the JAX package's ``ctc_loss_pallas`` gradients (interpret mode).

What the emulation keeps of the kernel: the reverse recursion over a
shared buffer of S + 2 positions (two log-zero pads past S), position s
reading s, s + 1 and s + 2 of the step before; the emission of a bf16
logit from the aligned 4-byte word that the ring's copy brings; z written
per step for t < len; then the gradient rows: g softmax sum(z) for every
class, sum(z) in the warp's order (lane partials, then the xor butterfly),
and the label positions written again from the first position of their
class, its duplicates summed along the links in the order of s, one
rounding to the logits' type. For f32 logits the kernel normalises each
row of z by its sum (g (softmax - label sums / sum(z))) where the label
can be aligned, as the plain version does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.ops.ctc_pallas import ctc_loss_pallas as jax_ctc_loss_pallas
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel
from asr_chinese_e2e_tpu_torch.ops.ctc import BIG_NEG, extend_labels

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_ctc.py


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def emulate_recursion(logits, ext, lens, lab_lens, lse, alpha, loss, blank=0):
    """z (B, T, S) f32 as ctc_beta_recursion_kernel writes it (zeros for t
    >= len, which the kernel leaves to the gradient pass)."""
    bsz, t_max, _ = logits.shape
    s = ext.shape[1]
    big = torch.tensor(BIG_NEG)
    idx = torch.arange(s)[None, :]
    two_on = torch.cat([ext[:, 2:], torch.full((bsz, 2), -1, dtype=ext.dtype)], 1)
    skip2 = (two_on >= 0) & (two_on != blank) & (two_on != ext)
    last = (2 * lab_lens.long()).clamp(max=s - 1)[:, None]
    fin = (idx == last) | (idx == (last - 1).clamp(min=0))
    emit = logits.float().gather(2, ext[:, None, :].expand(-1, t_max, -1)) - lse[..., None]
    beta = torch.full((bsz, s), BIG_NEG)
    pads = torch.full((bsz, 2), BIG_NEG)  # the shared buffer's two past S
    z = torch.zeros(bsz, t_max, s)
    for t in range(t_max - 1, -1, -1):
        e = emit[:, t]
        # s + 1 and s + 2 of the buffer, as contiguous copies (torch's CPU
        # logaddexp may round a strided operand otherwise)
        buf = torch.cat([beta, pads], 1)
        b1, b2 = buf[:, 1 : s + 1].contiguous(), buf[:, 2:].contiguous()
        new = torch.logaddexp(torch.logaddexp(beta, b1), torch.where(skip2, b2, big)) + e
        at_end = (t == lens.long() - 1)[:, None]
        running = (t < lens.long() - 1)[:, None]
        beta = torch.where(at_end, torch.where(fin, e, big), torch.where(running, new, beta))
        zt = torch.exp(torch.clamp(alpha[:, t] + beta - e + loss[:, None], max=0.0))
        z[:, t] = torch.where((t < lens.long())[:, None], zt, torch.zeros(()))
    return z


def word_logit(flat_bf16, idx):
    """The bf16 logit at flat index ``idx`` as the recursion reads it: the
    aligned 4-byte word holding it, its high half for an odd index."""
    words = flat_bf16.view(torch.int16).to(torch.int32) & 0xFFFF
    lo, hi = words[idx - idx % 2], words[idx - idx % 2 + 1]
    bits = torch.where(torch.as_tensor(idx % 2 == 1), hi, lo)
    return (bits << 16).view(torch.float32)


def links(ext_row):
    """(head, next) per position: the first position of its class, and the
    next position of the same class (S if none), as the gradient pass works
    them out per block."""
    ext_row = ext_row.tolist()
    s = len(ext_row)
    head, nxt = [True] * s, [s] * s
    for i, c in enumerate(ext_row):
        later = [j for j in range(i + 1, s) if ext_row[j] == c]
        nxt[i] = later[0] if later else s
        head[i] = c not in ext_row[:i]
    return head, nxt


def warp_sum(z):
    """sum over the last axis in the warp's order: lane l sums s = l, l +
    32, ... in turn, then the xor butterfly over 16, 8, 4, 2, 1."""
    s = z.shape[-1]
    pad = torch.nn.functional.pad(z, (0, -(-s // 32) * 32 - s))
    parts = torch.zeros(*z.shape[:-1], 32)
    for k in range(pad.shape[-1] // 32):
        parts = parts + pad[..., 32 * k : 32 * k + 32]
    for off in (16, 8, 4, 2, 1):
        parts = parts + parts[..., torch.arange(32) ^ off]
    return parts[..., 0]


def emulate_gradient(logits, ext, lens, lse, z, g, loss, zsum="warp"):
    """d_logits as ctc_grad_rows_kernel writes them; ``zsum="torch"`` sums
    z as the plain version does, to compare bit for bit. f32 logits: each
    row of z normalised by its sum where the loss is below 1e29 (w = 1, inv
    = 1 / sum(z)); bf16: w = sum(z), inv = 1."""
    softmax = torch.exp(logits.float() - lse[..., None])
    zs = warp_sum(z) if zsum == "warp" else z.sum(-1)
    w, inv = zs, torch.ones_like(zs)
    if logits.dtype == torch.float32:
        normalise = (loss < 1e29)[:, None]
        w = torch.where(normalise, (zs > 0).float(), zs)
        inv = torch.where(normalise, torch.where(zs > 0, 1.0 / zs, 0.0), inv)
    gb = g.float()[:, None, None]
    out = softmax * w[..., None] * gb
    for b in range(logits.shape[0]):
        head, nxt = links(ext[b])
        for s in (i for i in range(ext.shape[1]) if head[i]):
            total, n = z[b, :, s], nxt[s]
            while n < ext.shape[1]:
                total = total + z[b, :, n]
                n = nxt[n]
            c = int(ext[b, s])
            out[b, :, c] = (softmax[b, :, c] * w[b] - total * inv[b]) * gb[b, 0]
    t_ok = torch.arange(logits.shape[1])[None, :, None] < lens.long()[:, None, None]
    return torch.where(t_ok, out, torch.zeros(())).to(logits.dtype)


def make_case(b, t, c, label_pad, seed, repeats=False, dtype=torch.float32):
    """Logits, ragged logit lengths, labels filling up to ``label_pad`` (a
    small class set where ``repeats``: labels repeat, side by side and
    apart), their lengths; and the plain forward's (loss, alpha, lse)."""
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy((rng.randn(b, t, c) * 2.0).astype(np.float32)).to(dtype)
    lens = torch.tensor([t - 7 * i for i in range(b)], dtype=torch.int32)
    lab_lens = torch.tensor([label_pad - 3 * i for i in range(b)], dtype=torch.int32)
    hi = 4 if repeats else c
    labels = torch.from_numpy(rng.randint(1, hi, size=(b, label_pad)).astype(np.int32))
    labels = labels * (torch.arange(label_pad)[None, :] < lab_lens[:, None])
    ext = extend_labels(labels.long())
    loss, alpha, lse = ctc_kernel.ctc_alpha_reference(logits, ext, lens, lab_lens)
    g = torch.linspace(0.5, 1.5, b)
    return logits, lens, labels, lab_lens, ext, loss, alpha, lse, g


# S = 2 label_pad + 1: the flagship's 65, 401, 1023
CASES = {
    "S65": dict(b=3, t=80, c=40, label_pad=32, seed=0),
    "S65-repeats": dict(b=3, t=80, c=40, label_pad=32, seed=1, repeats=True),
    "S401-repeats": dict(b=2, t=420, c=30, label_pad=200, seed=2, repeats=True),
    "S1023": dict(b=2, t=600, c=30, label_pad=511, seed=3),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_emulation_is_the_plain_version_bit_for_bit(case, dtype):
    """The buffer recursion gives the plain recursion's z exactly, and the
    label rewrite (duplicates along the links, one rounding) the plain
    scatter exactly, f32 and bf16; the warp's order of sum(z) moves the
    gradient by rounding only."""
    logits, lens, _, lab_lens, ext, loss, alpha, lse, g = make_case(**CASES[case], dtype=dtype)
    want = ctc_kernel.ctc_beta_reference(logits, ext, lens, lab_lens, lse, alpha, loss, g)
    z = emulate_recursion(logits, ext, lens, lab_lens, lse, alpha, loss)
    got = emulate_gradient(logits, ext, lens, lse, z, g, loss, zsum="torch")
    assert got.dtype == want.dtype and torch.equal(got, want)
    warp = emulate_gradient(logits, ext, lens, lse, z, g, loss).float()
    bound = 1e-6 if dtype == torch.float32 else 1e-2  # bf16: one rounding apart at most
    assert (warp - want.float()).abs().max().item() <= bound


def test_ring_reads_bf16_logits_from_their_words():
    """The recursion copies the aligned 4-byte word that holds a bf16 logit
    (little-endian: the even index in the low half) and takes its half by
    the index's parity. (Where the count of logits is odd, the last one's
    word would pass the end: the kernel reads that one directly.)"""
    x = torch.randn(2 * 5 * 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    for i in range(x.numel()):
        assert word_logit(x, i).item() == x[i].float().item()


def test_links_sum_duplicates_in_order():
    ext = torch.tensor([0, 3, 0, 3, 0, 5, 0, 3, 0])
    head, nxt = links(ext)
    assert head == [True, True, False, False, False, True, False, False, False]
    assert nxt == [2, 3, 4, 7, 6, 9, 8, 9, 9]


@pytest.mark.parametrize("case", ["repeats", "label-longer-than-logits"])
def test_emulation_matches_jax_gradients(case):
    """Against ``ctc_loss_pallas``'s gradient in Pallas interpret mode, with
    repeated labels, and with a label longer than its logits (T = 6 frames
    for 9 labels)."""
    if case == "repeats":
        logits, lens, labels, lab_lens, ext, loss, alpha, lse, g = make_case(
            3, 40, 12, 10, seed=4, repeats=True)
    else:
        logits, lens, labels, lab_lens, ext, loss, alpha, lse, g = make_case(
            2, 6, 12, 9, seed=5)
        lens = torch.tensor([6, 6], dtype=torch.int32)
        loss, alpha, lse = ctc_kernel.ctc_alpha_reference(logits, ext, lens, lab_lens)
    z = emulate_recursion(logits, ext, lens, lab_lens, lse, alpha, loss)
    got = emulate_gradient(logits, ext, lens, lse, z, g, loss)
    assert bool(torch.isfinite(got).all())

    def total(x):
        per_utt = jax_ctc_loss_pallas(
            x, jnp.asarray(lens.numpy()), jnp.asarray(labels.numpy()),
            jnp.asarray(lab_lens.numpy()))
        return (per_utt * jnp.asarray(g.numpy())).sum()

    want = np.asarray(jax.grad(total)(jnp.asarray(logits.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **GRAD_TOL)


def test_wrapper_refuses_misaligned_logits():
    """K4's rows share the gradient's 16-byte alignment: a view that starts
    off it is refused before any launch."""
    class FakeCuda:
        device = torch.device("cuda")
        dtype = torch.float32
        shape = (2, 5, 9)

        def dim(self):
            return 3

        def is_contiguous(self):
            return True

        def data_ptr(self):
            return 4096 + 4

    with pytest.raises(ValueError, match="16-byte boundary"):
        ctc_kernel._check_kernel_inputs(FakeCuda(), None, None, None)
