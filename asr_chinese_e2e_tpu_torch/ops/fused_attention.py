"""Fused masked attention with in-kernel index-hash weight dropout
(``csrc/fused_attention_fwd.cu``): the port of the TPU kernel
``asr_chinese_e2e_tpu/ops/fused_attention.py::_fwd_kernel``.

``fused_attention_general`` takes (B, H, T, D) tensors. On a CPU tensor it
runs the plain version ``attention_reference`` (the counterpart of the JAX
package's ``_xla_attention``); on a CUDA tensor it launches the kernel or
raises. Forward only: the backward kernel (K2) is still to be ported.
"""

from __future__ import annotations

import numpy as np
import torch

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


def keep_mask_reference(seed, bsz, heads, tq, tk, rate, device=None):
    """(B, H, Tq, Tk) float32 keep mask scaled by 1/(1-rate): the murmur
    finalizer of (i, j, seed, b*H + h) in int64 arithmetic masked to 32
    bits, bit-exact with the JAX package's ``_xla_keep_mask``."""
    cell = (
        torch.arange(bsz, dtype=torch.int64, device=device)[:, None] * heads
        + torch.arange(heads, dtype=torch.int64, device=device)[None, :]
    )
    i = torch.arange(tq, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(tk, dtype=torch.int64, device=device)[None, :]
    seed_t = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=device)
    base = (_mul32(seed_t, 0xC2B2AE35) + _mul32(cell, 0x27D4EB2F)) & _M32
    x = (_mul32(i, 0x9E3779B9) ^ _mul32(j, 0x85EBCA6B))[None, None]
    x = x ^ base[:, :, None, None]
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    keep = (x >= _keep_threshold(rate)).to(torch.float32)
    return keep / np.float32(1.0 - rate)


def attention_reference(
    q, k, v, q_lengths, k_lengths, seed, scale, rate, causal, band=0
):
    """Plain torch version of the kernel: f32 scores, -1e9 on masked keys,
    f32 softmax, padded query rows zeroed, hash keep mask, (W o M) V with
    W cast to the value dtype."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
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
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    s = s + torch.where(mask, zero, NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = w * (qpos < q_lengths.to(dev)[:, None, None, None]).to(w.dtype)
    if rate > 0.0:
        w = w * keep_mask_reference(seed, q.shape[0], q.shape[1], tq, tk, rate, dev)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64)


def fused_attention_general(
    q, k, v, q_lengths, k_lengths, seed,
    scale: float, dropout_rate: float, causal: bool, band: int = 0,
):
    """q: (B, H, Tq, D); k/v: (B, H, Tk, D); q_lengths/k_lengths: (B,)
    valid query/key counts; seed: int (dropout stream). Returns (B, H, Tq,
    D) in q's dtype with padded query rows zeroed. ``causal`` masks kpos >
    qpos; ``band`` > 0 restricts keys to [q-band, q] (causal) or |q-k| <=
    band. Every k_length must be >= 1."""
    if q.device.type == "cpu":
        return attention_reference(
            q, k, v, q_lengths, k_lengths, seed, scale, dropout_rate, causal, band
        )
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
    if int(k_len.min()) < 1:  # host sync: an empty key row has no defined output
        raise ValueError("attention kernel: every k_length must be >= 1")
    out = _launch(q, k, v, q_len, k_len, seed, scale, dropout_rate, causal, band)
    fused_attention_general.launches += 1
    return out


def _launch(q, k, v, q_len, k_len, seed, scale, rate, causal, band):
    """Launch the kernel on tensors that ``fused_attention_general`` has
    checked (lengths int32 on q's device); returns the new output."""
    bsz, heads, tq, d = q.shape
    out = torch.empty_like(q)
    rate = float(rate)
    lib = load_library()
    with torch.cuda.device(q.device):
        err = lib.asr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_len.data_ptr(),
            k_len.data_ptr(), out.data_ptr(), bsz, heads, tq, k.shape[2], d,
            int(q.dtype == torch.bfloat16), float(scale), int(seed) & _M32,
            _keep_threshold(rate), float(np.float32(1.0 - rate)),
            int(rate > 0.0), int(bool(causal)), int(band),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_attention_fwd")
    return out


# kernel launches so far (the CPU path does not count)
fused_attention_general.launches = 0
