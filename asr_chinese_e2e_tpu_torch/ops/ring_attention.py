"""Ring attention: sequence parallelism over the mesh's ``seq`` axis
(``asr_chinese_e2e_tpu/ops/ring_attention.py``).

Each rank holds one block of T / n query rows and the matching key/value
block. The key/value blocks rotate around the ring (rank i sends to
i + 1, by ``torch.distributed.batch_isend_irecv``) while each rank folds
every block into its queries' online softmax, in f32; after n steps each
query block has seen every key. The bias of each step is rebuilt from the
source block's global offset, and a row with no valid key divides by 1.

The JAX package computes this with einsums under ``shard_map`` (no
Pallas kernel), so the products here are ``torch.einsum`` too. Point-to-
point ops carry no gradient, so it is an autograd Function: the backward
runs the ring in reverse (the transpose of ``ppermute``), recomputing each
step's weights from the saved row log-sum-exp; dK and dV travel with their
blocks and are home after n rotations.

gloo sends CPU tensors only: over gloo the ring runs on the CPU (the
tests) or at n = 1 (no send at all).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import group_rank, group_size

NEG_INF = -1e9


def _rotate(tensors, group, step: int):
    """Send each tensor to the rank ``step`` places on in the ring and
    receive its replacement from the rank ``step`` places back."""
    n, r = group_size(group), group_rank(group)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, src, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _block_bias(source: int, tk: int, key_valid, device):
    """(B, 1, 1, Tk) additive bias of the key block that started on rank
    ``source``: 0 on global positions below ``key_valid``, -1e9 above."""
    pos = source * tk + torch.arange(tk, device=device)
    valid = pos[None, :] < key_valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(valid, zero, NEG_INF)[:, None, None, :]


def _scores(q, k_blk, scale, bias):
    """(B, Tq, H, Tk) f32 scores of one block."""
    return torch.einsum("bqhd,bkhd->bqhk", q.float(), k_blk.float()) * scale + bias


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid, group, scale):
        n, r = group_size(group), group_rank(group)
        tk = k.shape[1]
        m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            source = (r - step) % n
            s = _scores(q, k_blk, scale, _block_bias(source, tk, key_valid, q.device))
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = alpha * acc + torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(),
                                             v_blk.float())
            m = m_next
            if step < n - 1:
                k_blk, v_blk = _rotate([k_blk, v_blk], group, 1)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l
        ctx.save_for_backward(q, k, v, key_valid, out, m + torch.log(l))
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, r = group_size(group), group_rank(group)
        tk = k.shape[1]
        g = dout.float()
        delta = (g * out).sum(-1, keepdim=True)  # (B, Tq, H, 1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        dk_blk = dv_blk = None
        # the forward's steps in reverse: step i holds the block of rank
        # r - i, one rotation back from the block of step i + 1
        for step in range(n - 1, -1, -1):
            if n > 1:
                moving = [k_blk, v_blk] + ([dk_blk, dv_blk] if dk_blk is not None else [])
                moving = _rotate(moving, group, -1)
                k_blk, v_blk = moving[:2]
                if dk_blk is not None:
                    dk_blk, dv_blk = moving[2:]
            if dk_blk is None:
                dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
                dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            source = (r - step) % n
            s = _scores(q, k_blk, scale, _block_bias(source, tk, key_valid, q.device))
            p = torch.exp(s - lse)
            dv_blk = dv_blk + torch.einsum("bqhk,bqhd->bkhd", p.to(v.dtype).float(), g)
            dp = torch.einsum("bqhd,bkhd->bqhk", g, v_blk.float())
            ds = p * (dp - delta) * scale
            dq = dq + torch.einsum("bqhk,bkhd->bqhd", ds, k_blk.float())
            dk_blk = dk_blk + torch.einsum("bqhk,bqhd->bkhd", ds, q.float())
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype), None, None, None)


def ring_attention(q, k, v, key_valid, group, scale=None):
    """Length-masked ring attention over the process ``group`` (the
    ``seq`` axis; None is a ring of one). q, k, v: this rank's (B, T_local,
    H, D) blocks, block i of the sequence on the group's rank i;
    ``key_valid``: (B,) the GLOBAL count of valid keys. Returns (B,
    T_local, H, D) in q's dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _RingAttention.apply(q, k, v, key_valid, group, float(scale))
