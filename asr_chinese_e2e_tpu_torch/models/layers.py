"""Shared torch layers: sinusoidal PE, multi-head attention with an explicit
KV cache for decoding, position-wise FFN, residual + LayerNorm sublayer.

Counterparts of ``asr_chinese_e2e_tpu/models/layers.py``. Dropout is the
identity at inference and is not ported yet (it comes with training), nor
are ``ConvModule`` and ``ConvSubsampler`` (ROADMAP §1). Attention logits
and softmax are f32 whatever the compute dtype, as in the JAX package.

The decode caches are updated IN PLACE (the JAX package returns new
arrays): a step writes position ``index`` of the caches it was given and
returns them, which saves a full cache copy per layer per step. A caller
that needs the old state must clone it first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import fused_attention_general

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
PE_MAX_LEN = 5000


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional encodings: sin on even dims, cos on odd dims,
    angle = pos / 10000^(2i/d)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    table = np.zeros((max_len, d_model))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


@functools.lru_cache(maxsize=8)
def pe_table(d_model: int, device: torch.device) -> torch.Tensor:
    """(PE_MAX_LEN, d_model) float32 table on ``device``, built once."""
    return torch.from_numpy(sinusoid_table(PE_MAX_LEN, d_model)).to(device)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = pe_table(self.d_model, x.device)
        return x + table[None, : x.shape[1]].to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA with additive-bias masking and explicit cache
    (temperature sqrt(d_k); residual + LN is the caller's)."""

    def __init__(self, num_heads: int, d_model: int, head_dim: int):
        super().__init__()
        self.num_heads, self.d_model, self.head_dim = num_heads, d_model, head_dim
        inner = num_heads * head_dim
        self.q_proj = nn.Linear(d_model, inner)
        self.k_proj = nn.Linear(d_model, inner)
        self.v_proj = nn.Linear(d_model, inner)
        self.out_proj = nn.Linear(inner, d_model)

    @property
    def scale(self) -> float:
        return 1.0 / float(np.sqrt(self.head_dim))

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T, H*d) -> (B, T, H, d)."""
        return y.reshape(*y.shape[:-1], self.num_heads, self.head_dim)

    def _merge_out(self, out: torch.Tensor) -> torch.Tensor:
        """(B, T, H, d) -> output projection (B, T, D)."""
        return self.out_proj(out.reshape(*out.shape[:-2], -1))

    def kv(self, kv_in: torch.Tensor):
        """Project keys/values once (cross-attention caches)."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def _attend(self, q, k, v, bias):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.scale
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self._merge_out(out)

    def forward(self, q_in, kv_in, bias):
        q = self._split(self.q_proj(q_in))
        k, v = self.kv(kv_in)
        return self._attend(q, k, v, bias)

    def _fused_general(self, q_in, kv_in, q_lengths, k_lengths, causal, band=0):
        """Project, run the fused attention kernel on (B, H, T, d), project
        out. Inference only: dropout rate 0."""
        q = self._split(self.q_proj(q_in))
        k, v = self.kv(kv_in)
        to_bhtd = lambda a: a.transpose(1, 2).contiguous()
        out = fused_attention_general(
            to_bhtd(q), to_bhtd(k), to_bhtd(v), q_lengths, k_lengths,
            0, self.scale, 0.0, causal, band,
        )
        return self._merge_out(out.transpose(1, 2))

    def fused(self, x, lengths):
        """Self-attention through the fused kernel (``attn_impl='fused'``)."""
        return self._fused_general(x, x, lengths, lengths, False)

    def fused_pattern(self, x, lengths, causal: bool, band: int):
        """Self-attention through the fused kernel with the banded /
        causal(-banded) pattern applied in the kernel."""
        return self._fused_general(x, x, lengths, lengths, causal, band=band)

    def step_self(self, x, cache: dict, index: int, bias):
        """Cached self-attention decode step. x: (B, 1, D); cache holds
        heads-major (B, H, Tmax, d) buffers, written in place at ``index``."""
        q = self._split(self.q_proj(x))  # (B, 1, H, d)
        k_new, v_new = self.kv(x)
        kc, vc = cache["k"], cache["v"]
        kc[:, :, index] = k_new[:, 0]
        vc[:, :, index] = v_new[:, 0]
        s = torch.einsum("bqhd,bhtd->bhqt", q.float(), kc.float()) * self.scale
        if bias is not None:
            s = s + bias
        w = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bhqt,bhtd->bqhd", w, vc)
        return self._merge_out(out), {"k": kc, "v": vc}

    def step_self_lazy(self, x, cache: dict, index: int, anc, bias):
        """Lazy-beam-reorder cached self-attention step: the cache stays
        unpermuted and ``anc`` (B, K, L) says, for the hypothesis now in
        slot k, which slot's cache holds its position-t entry. Scores are
        taken against every slot's cache and the ancestor's picked; the
        weights are routed back to the ancestor's V rows with a one-hot.
        x: (B*K, 1, D) in beam-slot order; bias broadcastable to
        (B, H, K, L)."""
        b, k_beam, l = anc.shape
        h, dk = self.num_heads, self.head_dim
        q = self._split(self.q_proj(x))  # (B*K, 1, H, d)
        k_new, v_new = self.kv(x)
        kc, vc = cache["k"], cache["v"]  # (B*K, H, L, d)
        kc[:, :, index] = k_new[:, 0]
        vc[:, :, index] = v_new[:, 0]
        qb = q.reshape(b, k_beam, h, dk)
        kb = kc.reshape(b, k_beam, h, l, dk)
        vb = vc.reshape(b, k_beam, h, l, dk)
        s_all = torch.einsum("bihd,bjhtd->bhijt", qb.float(), kb.float()) * self.scale
        idx = anc[:, None, :, None, :].expand(b, h, k_beam, 1, l)
        s = s_all.gather(3, idx).squeeze(3) + bias  # (B, H, K, L)
        w = torch.softmax(s, dim=-1)
        sel = F.one_hot(anc, k_beam).to(w.dtype)  # (B, K, L, K)
        wsel = (w[:, :, :, None, :] * sel.permute(0, 1, 3, 2)[:, None]).to(vc.dtype)
        out = torch.einsum("bhijt,bjhtd->bihd", wsel, vb)
        out = out.reshape(b * k_beam, 1, h, dk)
        return self._merge_out(out), {"k": kc, "v": vc}

    def step_cross(self, x, cache: dict, bias):
        """Cross-attention decode step against precomputed encoder k/v
        (B, T, H, d). Beam-folded: when the cache holds one row per
        utterance and queries arrive per hypothesis (B*K, 1, D), the beam
        dim folds into the query."""
        q = self._split(self.q_proj(x))  # (B*K, 1, H, d)
        kc, vc = cache["k"], cache["v"]
        k_beam = q.shape[0] // kc.shape[0]
        if k_beam == 1:
            return self._attend(q, kc, vc, bias)
        b = kc.shape[0]
        h, dk = self.num_heads, self.head_dim
        qb = q.reshape(b, k_beam, h, dk)
        s = torch.einsum("bkhd,bthd->bhkt", qb.float(), kc.float()) * self.scale
        if bias is not None:
            s = s + bias  # (B, 1, 1, T) broadcasts over (B, H, K, T)
        w = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bhkt,bthd->bkhd", w, vc)
        return self._merge_out(out.reshape(b * k_beam, 1, h, dk))

    def make_cache(self, batch: int, max_len: int, dtype, device):
        """Heads-major (B, H, T, d) zero caches."""
        shape = (batch, self.num_heads, max_len, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }


class PositionwiseFFN(nn.Module):
    """d_model -> d_ff -> d_model with ReLU."""

    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w1 = nn.Linear(d_model, d_ff)
        self.w2 = nn.Linear(d_ff, d_model)

    def forward(self, x):
        return self.w2(torch.relu(self.w1(x)))


class SubLayer(nn.Module):
    """Residual + LayerNorm: ``pre`` is x + f(norm(x)); ``post`` is
    norm(alpha*x + f(x)) (alpha > 1 is DeepNorm's residual scaling)."""

    def __init__(self, norm_type: str, d_model: int, alpha: float = 1.0):
        super().__init__()
        self.norm_type = norm_type
        self.alpha = alpha
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, fn, has_aux: bool = False):
        norm = self.norm
        if self.norm_type == "pre":
            if has_aux:
                y, aux = fn(norm(x))
                return x + y, aux
            return x + fn(norm(x))
        a = self.alpha
        if has_aux:
            y, aux = fn(x)
            return norm(a * x + y), aux
        return norm(a * x + fn(x))
