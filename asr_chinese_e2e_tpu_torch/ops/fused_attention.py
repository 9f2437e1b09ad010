"""Fused masked attention with in-kernel index-hash weight dropout, forward
(K1, ``csrc/fused_attention_fwd.cu``) and backward (K2,
``csrc/fused_attention_bwd.cu``): the port of the TPU kernels
``asr_chinese_e2e_tpu/ops/fused_attention.py::_fwd_kernel`` and
``_bwd_kernel``; and the windowed causal-band forward and backward (K6, K7,
``csrc/banded_attention.cu``), the port of ``_banded_fwd_kernel`` and
``_banded_bwd_kernel``. All four run bf16 inputs on the tensor cores
(``mma.sync``, ``csrc/mma.cuh``) and f32 inputs on FMAs.

``fused_attention_general`` takes (B, H, T, D) tensors and is
differentiable (a ``torch.autograd.Function``). A causal, ``band > 0``,
square call takes the windowed route when ``ASR_BANDED_WINDOW=1``, read at
every call (the JAX package's own switch, ``_use_banded_window``); every
other call takes the full-tile route. On CPU tensors it runs the plain
versions: ``attention_reference`` (the counterpart of the JAX package's
``_xla_attention``) and ``attention_backward_reference`` (the formula of
``_bwd_kernel``), or ``banded_attention_reference`` and
``banded_attention_backward_reference`` (the (BQ, 2 BQ) window tiles of
``_banded_tile`` and the formula of ``_banded_bwd_kernel`` with its dK/dV
shift-add); on CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check, load_library
from .masks import NEG_INF

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors holding uint32 values, without
    overflowing int64: split x into 16-bit halves."""
    lo = x & 0xFFFF
    hi = x >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & _M32


def _keep_threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _keep_from_index(seed, bsz, heads, i, j, rate, device=None):
    """(B, H, *broadcast(i, j)) float32 keep mask scaled by 1/(1-rate) at
    the int64 query / key indices ``i`` and ``j`` (taken mod 2**32, as the
    TPU kernels' uint32 casts do): the murmur finalizer of (i, j, seed,
    b*H + h) in int64 arithmetic masked to 32 bits."""
    cell = (
        torch.arange(bsz, dtype=torch.int64, device=device)[:, None] * heads
        + torch.arange(heads, dtype=torch.int64, device=device)[None, :]
    )
    seed_t = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)
    base = (_mul32(seed_t, 0xC2B2AE35) + _mul32(cell, 0x27D4EB2F)) & _M32
    x = _mul32(i & _M32, 0x9E3779B9) ^ _mul32(j & _M32, 0x85EBCA6B)
    x = x[None, None] ^ base.reshape(bsz, heads, *([1] * x.dim()))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = (x >= _keep_threshold(rate)).to(torch.float32)
    return keep / np.float32(1.0 - rate)


def keep_mask_reference(seed, bsz, heads, tq, tk, rate, device=None):
    """(B, H, Tq, Tk) float32 keep mask scaled by 1/(1-rate), bit-exact
    with the JAX package's ``_xla_keep_mask``."""
    i = torch.arange(tq, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(tk, dtype=torch.int64, device=device)[None, :]
    return _keep_from_index(seed, bsz, heads, i, j, rate, device)


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 inputs; f64 inputs stay f64 (gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def attention_weights(q, k, q_lengths, k_lengths, scale, causal, band=0):
    """The kernel's weights W: f32 scores with -1e9 on masked keys, row
    softmax, padded query rows zeroed. (B, H, Tq, Tk)."""
    ct = _compute_dtype(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    tq, tk = q.shape[2], k.shape[2]
    dev = q.device
    kpos = torch.arange(tk, device=dev)[None, None, None, :]
    mask = kpos < k_lengths.to(dev)[:, None, None, None]
    qpos = torch.arange(tq, device=dev)[None, None, :, None]
    if causal:
        mask = mask & (kpos <= qpos)
        if band > 0:
            mask = mask & (qpos - kpos <= band)
    elif band > 0:
        mask = mask & ((qpos - kpos).abs() <= band)
    zero = torch.zeros((), dtype=ct, device=dev)
    s = s + torch.where(mask, zero, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return w * (qpos < q_lengths.to(dev)[:, None, None, None]).to(w.dtype)


def attention_reference(
    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band=0
):
    """Plain torch version of the forward kernel: ``attention_weights``,
    hash keep mask, (W o M) V with W cast to the value dtype."""
    w = attention_weights(q, k, q_lengths, k_lengths, scale, causal, band)
    if rate > 0.0:
        bsz, heads, tq, tk = w.shape
        w = w * keep_mask_reference(seed, bsz, heads, tq, tk, rate, q.device).to(w.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


def attention_backward_reference(
    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band, dout
):
    """Plain torch version of the backward kernel, the explicit formula of
    the TPU kernel ``_bwd_kernel``: recompute W and M, then dV = (W o M)^T
    dO, dW = (dO V^T) o M, dS = W o (dW - rowsum(dW o W)), dQ = dS K scale,
    dK = dS^T Q scale. Arithmetic in f32 (f64 for f64 inputs); returns
    (dq, dk, dv) in the inputs' dtypes."""
    w = attention_weights(q, k, q_lengths, k_lengths, scale, causal, band)
    ct = w.dtype
    g = dout.to(ct)
    keep = None
    if rate > 0.0:
        bsz, heads, tq, tk = w.shape
        keep = keep_mask_reference(seed, bsz, heads, tq, tk, rate, q.device).to(ct)
    wd = w * keep if keep is not None else w
    dv = torch.einsum("bhqk,bhqd->bhkd", wd, g)
    dw = torch.einsum("bhqd,bhkd->bhqk", g, v.to(ct))
    if keep is not None:
        dw = dw * keep
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ct)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- the windowed causal-band route (K6 / K7) ----------------------------------


def _banded_window_enabled() -> bool:
    """``ASR_BANDED_WINDOW=1``, read at every call as the JAX package does."""
    return os.environ.get("ASR_BANDED_WINDOW", "0") == "1"


def _block_q(band: int) -> int:
    """Query block BQ: the smallest multiple of 64 >= band."""
    return 64 * max(1, -(-band // 64))


def _use_banded_window(q, k, causal, band) -> bool:
    """The JAX package's predicate: causal, band > 0, Tq == Tk, and the
    switch on."""
    return (
        causal
        and band > 0
        and q.shape[2] == k.shape[2]
        and _banded_window_enabled()
    )


# 64-row tiles of the other side that the tensor-core K6/K7 keep resident
# per block (``banded_attention.cu::MAX_TILES``)
MAX_RESIDENT_TILES = 12


def _window_fits(q, band) -> bool:
    """Whether K6/K7 serve this band over q's T: the tensor-core (bf16)
    kernels hold a block's whole window, ceil(band / 64) + 1 tiles of 64
    rows and no more than T holds, up to ``MAX_RESIDENT_TILES``; the FMA
    kernels (f32) serve any band. Decided on the host from band, T and
    dtype, before any launch."""
    if q.dtype != torch.bfloat16:
        return True
    tiles = min(_block_q(band) // 64 + 1, -(-q.shape[2] // 64))
    return tiles <= MAX_RESIDENT_TILES


def _query_blocks(x, bq, nc):
    """(B, H, T, D) -> (B, H, nc, BQ, D), zero rows past T."""
    b, h, t, d = x.shape
    return F.pad(x, (0, 0, 0, nc * bq - t)).reshape(b, h, nc, bq, d)


def _key_windows(x, bq, nc):
    """(B, H, T, D) -> (B, H, nc, 2 BQ, D): key blocks c-1 and c of each
    query block c (zero rows before key 0 and past T)."""
    xp = F.pad(x, (0, 0, bq, nc * bq - x.shape[2]))
    return xp.unfold(2, 2 * bq, bq).transpose(-1, -2)


def _banded_weights(q, k, n, seed, scale, rate, band):
    """The (BQ, 2 BQ) window tiles of ``_banded_tile``, all blocks at once:
    (W, keep or None, BQ, nc). Query qg = c BQ + i, key kg = (c-1) BQ + j;
    a key is visible when kg >= 0, kg < n, qg >= kg and qg - kg <= band;
    masked scores get -1e9; rows with qg >= n are zeroed; the keep mask is
    hashed at (qg, kg, seed, b*H + h). W and keep are (B, H, nc, BQ, 2 BQ)
    in f32 (f64 for f64 inputs)."""
    ct = _compute_dtype(q.dtype)
    bsz, heads, t, _ = q.shape
    bq = _block_q(band)
    nc = -(-t // bq)
    dev = q.device
    s = torch.einsum(
        "bhcid,bhcjd->bhcij",
        _query_blocks(q.to(ct), bq, nc), _key_windows(k.to(ct), bq, nc),
    ) * scale
    c = torch.arange(nc, dtype=torch.int64, device=dev)[:, None, None]
    qg = c * bq + torch.arange(bq, dtype=torch.int64, device=dev)[None, :, None]
    kg = (c - 1) * bq + torch.arange(2 * bq, dtype=torch.int64, device=dev)[None, None, :]
    nb = n.to(device=dev, dtype=torch.int64)[:, None, None, None, None]
    mask = (kg >= 0) & (kg < nb) & (qg >= kg) & (qg - kg <= band)
    zero = torch.zeros((), dtype=ct, device=dev)
    w = torch.softmax(s + torch.where(mask, zero, NEG_INF), dim=-1)
    w = w * (qg < nb).to(ct)
    keep = None
    if rate > 0.0:
        keep = _keep_from_index(seed, bsz, heads, qg, kg, rate, dev).to(ct)
    return w, keep, bq, nc


def banded_attention_reference(q, k, v, lengths, seed, scale, rate, band):
    """Plain torch version of K6 (``_banded_fwd_kernel``): causal band
    attention over the (BQ, 2 BQ) window tiles, ``lengths`` masking keys
    and zeroing query rows, hash keep mask at global indices, (W o M) V in
    f32 (the TPU kernel rounds W o M to the value dtype first; K6 does
    not, see ``csrc/banded_attention.cu``). (B, H, T, D) in v's dtype."""
    t = q.shape[2]
    w, keep, bq, nc = _banded_weights(q, k, lengths, seed, scale, rate, band)
    if keep is not None:
        w = w * keep
    out = torch.einsum("bhcij,bhcjd->bhcid", w, _key_windows(v.to(w.dtype), bq, nc))
    return out.reshape(*out.shape[:2], nc * bq, -1)[:, :, :t].to(v.dtype)


def banded_attention_backward_reference(
    q, k, v, lengths, seed, scale, rate, band, dout
):
    """Plain torch version of K7: the formula of ``_banded_bwd_kernel`` per
    window tile (dV2 = (W o M)^T dO, dW = (dO V2^T) o M, dS = W o (dW -
    rowsum(dW o W)), dQ = dS K2 scale, dK2 = dS^T Q scale), then the
    shift-add of ``_banded_bwd``: a tile's first BQ key rows belong to key
    block c-1. Arithmetic in f32 (f64 for f64 inputs); returns (dq, dk,
    dv) in the inputs' dtypes."""
    t = q.shape[2]
    w, keep, bq, nc = _banded_weights(q, k, lengths, seed, scale, rate, band)
    ct = w.dtype
    g = _query_blocks(dout.to(ct), bq, nc)
    wd = w * keep if keep is not None else w
    dv2 = torch.einsum("bhcij,bhcid->bhcjd", wd, g)
    dw = torch.einsum("bhcid,bhcjd->bhcij", g, _key_windows(v.to(ct), bq, nc))
    if keep is not None:
        dw = dw * keep
    ds = w * (dw - (dw * w).sum(-1, keepdim=True))
    dq = torch.einsum("bhcij,bhcjd->bhcid", ds, _key_windows(k.to(ct), bq, nc)) * scale
    dk2 = torch.einsum("bhcij,bhcid->bhcjd", ds, _query_blocks(q.to(ct), bq, nc)) * scale

    def shift_add(x2):
        x = x2[:, :, :, bq:].clone()
        x[:, :, :-1] += x2[:, :, 1:, :bq]
        return x.reshape(*x.shape[:2], nc * bq, -1)[:, :, :t]

    dq = dq.reshape(*dq.shape[:2], nc * bq, -1)[:, :, :t]
    return dq.to(q.dtype), shift_add(dk2).to(k.dtype), shift_add(dv2).to(v.dtype)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64)


def _check_tensors(q, k, v):
    """Device, shapes, dtypes and layout the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"attention kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    bsz, heads, _, d = q.shape
    if k.shape[0] != bsz or k.shape[1] != heads or k.shape[3] != d:
        raise ValueError("attention kernel: q and k/v disagree on B, H or D")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel: dtypes {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel: head dim {d} not in {_KERNEL_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel: q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("attention kernel: q, k and v on different devices")


def _check_kernel_inputs(q, k, v, q_lengths, k_lengths):
    """Validate inputs for the kernels; returns (q_len, k_len) as int32 on
    q's device. The one host sync of an attention call, forward and
    backward."""
    _check_tensors(q, k, v)
    bsz = q.shape[0]
    q_len = q_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    k_len = k_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if q_len.shape != (bsz,) or k_len.shape != (bsz,):
        raise ValueError("attention kernel: lengths must be (B,)")
    # host sync: an empty key row has no defined output
    if int(k_len.min()) < 1:
        raise ValueError("attention kernel: every k_length must be >= 1")
    return q_len, k_len


def _check_banded(err: int, name: str, q, band: int) -> None:
    """Raise on what a banded entry point returned. A negative code is the
    refusal of the tensor-core K6/K7, made before any launch: they keep a
    block's whole window in shared memory, ceil(band / 64) + 1 tiles of 64
    rows (no more than T holds), and the code is minus the most they hold."""
    if err < 0:
        raise ValueError(
            f"banded attention kernel: band {band} over {q.shape[2]} frames needs more "
            f"than {-err} resident tiles of 64 rows (bf16)"
        )
    check(err, name)


def _dropout_args(seed, rate):
    rate = float(rate)
    return (
        int(seed) & _M32, _keep_threshold(rate), float(np.float32(1.0 - rate)),
        int(rate > 0.0),
    )


def _residual_ptr(q, out_lo):
    """The pointer of the output's rounding residual, which only the bf16
    kernels write and read."""
    if out_lo is None or q.dtype != torch.bfloat16:
        return None
    if out_lo.shape != q.shape or out_lo.dtype != q.dtype or not out_lo.is_contiguous():
        raise ValueError("attention kernel: out_lo must be like q")
    return out_lo.data_ptr()


def row_stats_like(q):
    """An empty (B, H, Tq, 2) f32 tensor for K1's row statistics."""
    return torch.empty((*q.shape[:3], 2), dtype=torch.float32, device=q.device)


def _launch(q, k, v, q_len, k_len, seed, scale, rate, causal, band, stats=None, out_lo=None):
    """Launch the forward kernel on tensors that ``_check_kernel_inputs``
    has checked; returns the new output. ``stats``, when given, is a (B,
    H, Tq, 2) f32 tensor (``row_stats_like``) that receives each row's
    score maximum and the log of its sum of exp(score - max), apart, in
    the kernel's units (natural for f32, log 2 for bf16), from which K2
    rebuilds the weights; ``out_lo``, when given (bf16 only), a tensor
    like q that receives what the rounding of the output to bf16 took
    away (K2 takes D from the two together)."""
    bsz, heads, tq, d = q.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_len.data_ptr(),
            k_len.data_ptr(), out.data_ptr(), _residual_ptr(q, out_lo),
            None if stats is None else stats.data_ptr(),
            bsz, heads, tq, k.shape[2], d, int(q.dtype == torch.bfloat16),
            float(scale), *_dropout_args(seed, rate), int(bool(causal)), int(band),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_attention_fwd")
    fused_attention_general.launches += 1
    return out


def _check_backward_tensors(q, rows, dout, *same_as_q, per_row: int = 1):
    """dO in q's dtype and contiguous, after the shape and layout checks
    the backward kernels need beyond ``_check_tensors``: ``rows`` is what
    the forward saved per query row, ``per_row`` f32 values each (K7: the
    log-sum-exp, (B, H, T); K2: the statistics, (B, H, Tq, 2))."""
    if dout.shape != q.shape or any(x.shape != q.shape for x in same_as_q):
        raise ValueError("attention backward kernel: out/dout shapes")
    want = tuple(q.shape[:3]) + ((per_row,) if per_row > 1 else ())
    if tuple(rows.shape) != want or rows.dtype != torch.float32:
        raise ValueError(f"attention backward kernel: row values must be {want} f32")
    if not (rows.is_contiguous() and all(x.is_contiguous() for x in same_as_q)):
        raise ValueError("attention backward kernel: out and row values contiguous")
    return dout.to(q.dtype).contiguous()


def _launch_backward(
    q, k, v, out, stats, q_len, k_len, seed, scale, rate, causal, band, dout, out_lo=None
):
    """Launch K2 on tensors and int32 lengths that have been checked (by
    ``attention_backward_kernel``, or by the forward of the autograd
    Function, whose one host sync covers the backward too). ``stats``: K1's
    row statistics; ``out_lo``: what K1 wrote beside a bf16 ``out``;
    without it D comes from the rounded output alone."""
    bsz, heads, tq, d = q.shape
    dout = _check_backward_tensors(q, stats, dout, out, per_row=2)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bsz, heads, tq), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _residual_ptr(q, out_lo), dout.data_ptr(), stats.data_ptr(),
            q_len.data_ptr(), k_len.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bsz, heads, tq, k.shape[2], d, int(q.dtype == torch.bfloat16),
            float(scale), *_dropout_args(seed, rate), int(bool(causal)), int(band),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_attention_bwd")
    attention_backward_kernel.launches += 1
    return dq, dk, dv


def attention_backward_kernel(
    q, k, v, out, stats, q_lengths, k_lengths, seed, scale, rate, causal, band, dout,
    out_lo=None,
):
    """K2: (dq, dk, dv) in the inputs' dtype, from the forward's output and
    row statistics (``stats``, (B, H, Tq, 2) f32 as K1 writes them), and
    for bf16 the output's rounding residual (``out_lo``) where K1 wrote it.
    CUDA tensors only. A query row that sees no key (a band, and the row
    more than the band past its k_length) weighs every key alike, as in
    the plain version."""
    q_len, k_len = _check_kernel_inputs(q, k, v, q_lengths, k_lengths)
    return _launch_backward(
        q, k, v, out, stats, q_len, k_len, seed, scale, rate, causal, band, dout, out_lo
    )


def banded_attention_kernel(q, k, v, n, seed, scale, rate, band, lse=None):
    """K6: the windowed causal-band forward on tensors that
    ``_check_kernel_inputs`` has checked (``n``: (B,) int32 lengths on the
    card, masking keys and zeroing query rows); returns the new output.
    ``lse``, when given, is a (B, H, T) f32 tensor that receives each
    row's log-sum-exp."""
    bsz, heads, t, d = q.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_banded_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            bsz, heads, t, d, int(q.dtype == torch.bfloat16), float(scale),
            *_dropout_args(seed, rate), int(band), _block_q(band),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_banded(err, "asr_banded_attention_fwd", q, band)
    banded_attention_kernel.launches += 1
    return out


def _launch_banded_backward(q, k, v, lse, n, seed, scale, rate, band, dout):
    """Launch K7 on tensors and int32 lengths (``n``, on the card) that
    have been checked, by ``banded_attention_backward_kernel`` or by the
    forward of the autograd Function."""
    bsz, heads, t, d = q.shape
    dout = _check_backward_tensors(q, lse, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bsz, heads, t), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_banded_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), n.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bsz, heads, t, d, int(q.dtype == torch.bfloat16), float(scale),
            *_dropout_args(seed, rate), int(band), _block_q(band),
            torch.cuda.current_stream().cuda_stream,
        )
    _check_banded(err, "asr_banded_attention_bwd", q, band)
    banded_attention_backward_kernel.launches += 1
    return dq, dk, dv


def banded_attention_backward_kernel(q, k, v, lse, lengths, seed, scale, rate, band, dout):
    """K7: (dq, dk, dv) in the inputs' dtype, from K6's row log-sum-exp
    (``lse``, (B, H, T) f32; on this route row i below its length sees key
    i, so a single log-sum-exp serves). CUDA tensors only."""
    _, n = _check_kernel_inputs(q, k, v, lengths, lengths)
    if k.shape != q.shape:
        raise ValueError("banded attention backward kernel: q/k/v shapes")
    return _launch_banded_backward(q, k, v, lse, n, seed, scale, rate, band, dout)


def _forward_kernels(
    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band, banded, needs_grad
):
    """K1, or K6 on the windowed route, after the call's one validation and
    host sync; returns (out, what the backward needs or None), and the
    backward launches on these lengths unchecked. What the backward needs
    of each row: K6's log-sum-exp (B, H, T), or K1's row max and log-sum
    apart (B, H, Tq, 2), which serve a row that sees no key too."""
    q_len, k_len = _check_kernel_inputs(q, k, v, q_lengths, k_lengths)
    rows = out_lo = None
    if banded:
        if needs_grad:
            rows = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = banded_attention_kernel(q, k, v, k_len, seed, scale, rate, band, rows)
    else:
        if needs_grad:
            rows = row_stats_like(q)
            if q.dtype == torch.bfloat16:
                out_lo = torch.empty_like(q)
        out = _launch(q, k, v, q_len, k_len, seed, scale, rate, causal, band, rows, out_lo)
    if not needs_grad:
        return out, None
    # K7 needs no forward output; K2 takes D from a bf16 output and its residual
    return out, (q, k, v, q_len, k_len, None if banded else out, rows, out_lo)


class _FusedAttention(torch.autograd.Function):
    """Forward K1 and backward K2, or K6 and K7 on the windowed route
    (plain versions on the CPU). The route is chosen once, in ``forward``.
    Saves q, k, v and, on the card, the checked int32 lengths and the row
    values (K6's log-sum-exp, or K1's max and log-sum; and the output, with
    its rounding residual in bf16, which K2 needs and K7 does not): no
    (Tq, Tk) tensor is kept for the backward,
    and the backward makes no host sync of its own. The windowed route
    passes ``k_lengths`` as its one length, as the JAX package does."""

    @staticmethod
    def forward(ctx, q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band):
        windowed = _use_banded_window(q, k, causal, band)
        banded = windowed and _window_fits(q, band)
        if windowed and not banded:
            # a window wider than K6/K7 hold: K1/K2 on the same causal band
            # with the windowed route's one length for both, and the same
            # dropout draws (the keep hash is by global (query, key) index)
            q_lengths = k_lengths
        ctx.args = (seed, scale, rate, causal, band, banded)
        needs_grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            if banded:
                out = banded_attention_reference(
                    q, k, v, k_lengths, seed, scale, rate, band
                )
            else:
                out = attention_reference(
                    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band
                )
            if needs_grad:
                ctx.save_for_backward(q, k, v, q_lengths, k_lengths)
            return out
        out, saved = _forward_kernels(
            q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band, banded,
            needs_grad,
        )
        if saved is not None:
            ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        seed, scale, rate, causal, band, banded = ctx.args
        saved = ctx.saved_tensors
        if saved[0].device.type == "cpu":
            q, k, v, q_lengths, k_lengths = saved
            if banded:
                grads = banded_attention_backward_reference(
                    q, k, v, k_lengths, seed, scale, rate, band, dout
                )
            else:
                grads = attention_backward_reference(
                    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band,
                    dout,
                )
        else:
            q, k, v, q_len, k_len, out, rows, out_lo = saved
            if banded:
                grads = _launch_banded_backward(
                    q, k, v, rows, k_len, seed, scale, rate, band, dout
                )
            else:
                grads = _launch_backward(
                    q, k, v, out, rows, q_len, k_len, seed, scale, rate, causal, band,
                    dout, out_lo,
                )
        return (*grads, None, None, None, None, None, None, None)


def fused_attention_general(
    q, k, v, q_lengths, k_lengths, seed,
    scale: float, dropout_rate: float, causal: bool, band: int = 0,
):
    """q: (B, H, Tq, D); k/v: (B, H, Tk, D); q_lengths/k_lengths: (B,)
    valid query/key counts; seed: int (dropout stream). Returns (B, H, Tq,
    D) in q's dtype with padded query rows zeroed; differentiable in q, k
    and v. ``causal`` masks kpos > qpos; ``band`` > 0 restricts keys to
    [q-band, q] (causal) or |q-k| <= band; a query row that sees no key
    averages over all Tk keys, forward and backward, as the JAX package's
    kernels do. Every k_length must be >= 1, else ValueError.
    With ``ASR_BANDED_WINDOW=1`` a causal, banded, square call takes the
    windowed route (K6/K7), where ``k_lengths`` masks keys and zeroes
    query rows; a bf16 window wider than K6/K7 hold (``_window_fits``)
    takes K1/K2 with ``k_lengths`` as both lengths, which computes the
    same function."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    return _FusedAttention.apply(
        q, k, v, q_lengths, k_lengths, int(seed), float(scale),
        float(dropout_rate), bool(causal), int(band),
    )


def fused_attention(q, k, v, lengths, seed, scale: float, dropout_rate: float):
    """Square self-attention (Tq == Tk, one length mask for queries and
    keys), the encoder's entry point of ``fused_attention_general``."""
    return fused_attention_general(q, k, v, lengths, lengths, seed, scale, dropout_rate, False)


# the keep hash's seed and cell terms, seed * A + cell * K (mod 2**32,
# csrc/common.cuh::keep_hash): a cell offset c moves the seed by c K / A
_SEED_MUL, _CELL_MUL = 0xC2B2AE35, 0x27D4EB2F
_SEED_PER_CELL = (_CELL_MUL * pow(_SEED_MUL, -1, 1 << 32)) & _M32


def seed_at_cell(seed: int, cell: int) -> int:
    """The seed whose keep mask over cells (b, h) equals ``seed``'s over
    cells (b, h) + ``cell``: a call on rows [r, r + B) of a batch draws
    what the whole batch's call draws on them with ``seed_at_cell(seed, r
    H)``."""
    return (int(seed) + int(cell) * _SEED_PER_CELL) & _M32


def fused_attention_sharded_general(
    mesh, q, k, v, q_lengths, k_lengths, seed,
    scale: float, dropout_rate: float, causal: bool, band: int = 0,
    heads_split: bool = True,
):
    """``fused_attention_general`` on this rank's rows (of ``data``) and
    heads (of ``model``, where ``heads_split``) of the global call, the
    counterpart of the JAX package's ``fused_attention_sharded_general``:
    the kernels are per (batch, head) independent, so sharding needs no
    communication. Its dropout seed is folded as there, seed + data_index
    * model + model_index, so each rank's keep hash (local (b, h) cells)
    is the JAX sharded call's. Where JAX falls back to the unsharded call
    (data = model = 1, or heads that do not split: ``heads_split`` False
    under model > 1) the seed moves to this rank's first global cell
    instead, which draws the unsharded call's mask on these rows. (A batch
    that does not divide ``data`` is not split at all: the caller runs it
    under ``mesh.without("data")``.)"""
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    if dropout_rate > 0.0 and (dp > 1 or tp > 1):
        d = mesh.index("data")
        if heads_split or tp == 1:
            seed = int(seed) + d * tp + (mesh.index("model") if tp > 1 else 0)
        else:
            seed = seed_at_cell(seed, d * q.shape[0] * q.shape[1])
    return fused_attention_general(
        q, k, v, q_lengths, k_lengths, int(seed) & _M32, scale, dropout_rate, causal, band)


def fused_attention_sharded(
    mesh, q, k, v, lengths, seed, scale: float, dropout_rate: float, heads_split: bool = True,
):
    """Square (encoder) entry point of ``fused_attention_sharded_general``."""
    return fused_attention_sharded_general(
        mesh, q, k, v, lengths, lengths, seed, scale, dropout_rate, False,
        heads_split=heads_split)


# kernel launches so far (the CPU path does not count)
fused_attention_general.launches = 0
attention_backward_kernel.launches = 0
banded_attention_kernel.launches = 0
banded_attention_backward_kernel.launches = 0
