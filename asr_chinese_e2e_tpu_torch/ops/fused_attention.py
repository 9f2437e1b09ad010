"""Fused masked attention with in-kernel index-hash weight dropout, forward
(K1, ``csrc/fused_attention_fwd.cu``) and backward (K2,
``csrc/fused_attention_bwd.cu``): the port of the TPU kernels
``asr_chinese_e2e_tpu/ops/fused_attention.py::_fwd_kernel`` and
``_bwd_kernel``; and the windowed causal-band forward and backward (K6, K7,
``csrc/banded_attention.cu``), the port of ``_banded_fwd_kernel`` and
``_banded_bwd_kernel``. K1 and K2 run bf16 inputs on the tensor cores
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


def keyless_row_gap(q_lengths, k_lengths, tq: int, tk: int):
    """(B,) by how many rows the queries outlast the keys: under a band
    (causal or not) query row i sees no key at all when i - band is past
    the last key, so an utterance has such a row when its gap exceeds the
    band."""
    return q_lengths.clamp(max=tq) - k_lengths.clamp(max=tk)


def _check_kernel_inputs(q, k, v, q_lengths, k_lengths, backward_band: int = 0):
    """Validate inputs for the kernels; returns (q_len, k_len) as int32 on
    q's device. ``backward_band`` > 0: the call is a backward under that
    band, which recomputes the weights from the row log-sum-exp and so
    refuses a query row without a visible key (its scores are all -1e9,
    where f32 absorbs the log Tk of its log-sum-exp)."""
    if q.device.type != "cuda":
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"attention kernel: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}"
        )
    bsz, heads, tq, d = q.shape
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
    q_len = q_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    k_len = k_lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if q_len.shape != (bsz,) or k_len.shape != (bsz,):
        raise ValueError("attention kernel: lengths must be (B,)")
    # host sync (one for both values): an empty key row has no defined output
    if backward_band > 0:
        gap = keyless_row_gap(q_len, k_len, tq, k.shape[2]).max()
        k_min, gap = torch.stack([k_len.min(), gap]).tolist()
    else:
        k_min, gap = int(k_len.min()), 0
    if k_min < 1:
        raise ValueError("attention kernel: every k_length must be >= 1")
    if gap > backward_band:
        raise ValueError(
            f"attention backward kernel: a query row sees no key (q_length exceeds "
            f"k_length by {gap} > band {backward_band})"
        )
    return q_len, k_len


def _dropout_args(seed, rate):
    rate = float(rate)
    return (
        int(seed) & _M32, _keep_threshold(rate), float(np.float32(1.0 - rate)),
        int(rate > 0.0),
    )


def _launch(q, k, v, q_len, k_len, seed, scale, rate, causal, band, lse=None):
    """Launch the forward kernel on tensors that ``_check_kernel_inputs``
    has checked; returns the new output. ``lse``, when given, is a (B, H,
    Tq) f32 tensor that receives each row's log-sum-exp."""
    bsz, heads, tq, d = q.shape
    out = torch.empty_like(q)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_len.data_ptr(),
            k_len.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            bsz, heads, tq, k.shape[2], d, int(q.dtype == torch.bfloat16),
            float(scale), *_dropout_args(seed, rate), int(bool(causal)), int(band),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_attention_fwd")
    fused_attention_general.launches += 1
    return out


def attention_backward_kernel(
    q, k, v, out, lse, q_lengths, k_lengths, seed, scale, rate, causal, band, dout
):
    """K2: (dq, dk, dv) in the inputs' dtype, from the forward's output and
    row log-sum-exp (``lse``, (B, H, Tq) f32). CUDA tensors only. Under a
    band every query row below its q_length must see a key: q_length <=
    k_length + band, else ValueError."""
    q_len, k_len = _check_kernel_inputs(q, k, v, q_lengths, k_lengths, int(band))
    bsz, heads, tq, d = q.shape
    dout = dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (bsz, heads, tq):
        raise ValueError("attention backward kernel: out/dout/lse shapes")
    if lse.dtype != torch.float32 or not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("attention backward kernel: lse f32, out/lse contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bsz, heads, tq), dtype=torch.float32, device=q.device)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bsz, heads, tq, k.shape[2], d, int(q.dtype == torch.bfloat16),
            float(scale), *_dropout_args(seed, rate), int(bool(causal)), int(band),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_attention_bwd")
    attention_backward_kernel.launches += 1
    return dq, dk, dv


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
    check(err, "asr_banded_attention_fwd")
    banded_attention_kernel.launches += 1
    return out


def banded_attention_backward_kernel(q, k, v, lse, lengths, seed, scale, rate, band, dout):
    """K7: (dq, dk, dv) in the inputs' dtype, from K6's row log-sum-exp
    (``lse``, (B, H, T) f32). CUDA tensors only."""
    _, n = _check_kernel_inputs(q, k, v, lengths, lengths)
    bsz, heads, t, d = q.shape
    dout = dout.to(q.dtype).contiguous()
    if k.shape != q.shape or dout.shape != q.shape:
        raise ValueError("banded attention backward kernel: q/k/v/dout shapes")
    if lse.shape != (bsz, heads, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("banded attention backward kernel: lse must be (B, H, T) f32")
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
    check(err, "asr_banded_attention_bwd")
    banded_attention_backward_kernel.launches += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """Forward K1 and backward K2, or K6 and K7 on the windowed route
    (plain versions on the CPU). The route is chosen once, in ``forward``.
    Saves q, k, v and, on the card, the row log-sum-exp (and the output,
    which K2 needs and K7 does not): no
    (Tq, Tk) tensor is kept for the backward. The windowed route passes
    ``k_lengths`` as its one length, as the JAX package does."""

    @staticmethod
    def forward(ctx, q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band):
        banded = _use_banded_window(q, k, causal, band)
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
        q_len, k_len = _check_kernel_inputs(q, k, v, q_lengths, k_lengths)
        lse = None
        if needs_grad:
            lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        if banded:
            out = banded_attention_kernel(q, k, v, k_len, seed, scale, rate, band, lse)
        else:
            out = _launch(q, k, v, q_len, k_len, seed, scale, rate, causal, band, lse)
        if needs_grad:  # K7 needs no forward output
            ctx.save_for_backward(q, k, v, q_len, k_len, None if banded else out, lse)
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
            q, k, v, q_len, k_len, out, lse = saved
            if banded:
                grads = banded_attention_backward_kernel(
                    q, k, v, lse, k_len, seed, scale, rate, band, dout
                )
            else:
                grads = attention_backward_kernel(
                    q, k, v, out, lse, q_len, k_len, seed, scale, rate, causal, band,
                    dout,
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
    [q-band, q] (causal) or |q-k| <= band. Every k_length must be >= 1;
    on the card the backward under a band also needs q_length <= k_length +
    band (every query row sees a key), else it raises ValueError.
    With ``ASR_BANDED_WINDOW=1`` a causal, banded, square call takes the
    windowed route (K6/K7), where ``k_lengths`` masks keys and zeroes
    query rows."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention kernel: unsupported device {q.device}")
    return _FusedAttention.apply(
        q, k, v, q_lengths, k_lengths, int(seed), float(scale),
        float(dropout_rate), bool(causal), int(band),
    )


# kernel launches so far (the CPU path does not count)
fused_attention_general.launches = 0
attention_backward_kernel.launches = 0
banded_attention_kernel.launches = 0
banded_attention_backward_kernel.launches = 0
