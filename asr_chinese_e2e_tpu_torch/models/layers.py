"""Shared torch layers: dropout, sinusoidal PE, multi-head attention with an
explicit KV cache for decoding, position-wise FFN, residual + LayerNorm
sublayer, the conformer's convolution module and the conv2d subsampling
frontend.

Counterparts of ``asr_chinese_e2e_tpu/models/layers.py``. The convolutions
are PyTorch calls (``F.conv1d`` depthwise, ``F.conv2d``), as the JAX
package computes them in XLA (``nn.Conv``), not in a Pallas kernel.

Precision follows flax's ``dtype`` / ``param_dtype`` split: parameters
stay float32 (the optimizer's master weights) and each layer casts them
to its compute dtype where it uses them (``Dense``, ``Embedding``, the
convolutions);
LayerNorm statistics are f32 and its output is in the compute dtype.
cuDNN's f32 convolutions and recurrences stay f32 (``keep_cudnn_f32``).
Attention logits and softmax are f32 whatever the compute dtype. A model
moved to bf16 with ``.to(dtype=...)`` (the serving path) computes the
same way, with casts that are no-ops.

Randomness is explicit: every ``forward`` that can drop takes ``rng``, a
CPU ``torch.Generator`` from which each dropout call draws its own seed
(the counterpart of flax's ``rngs={"dropout": key}``); None is the
deterministic, inference path.

The decode caches are updated IN PLACE (the JAX package returns new
arrays): a step writes position ``index`` of the caches it was given and
returns them, which saves a full cache copy per layer per step. A caller
that needs the old state must clone it first.

Under a mesh (``parallel/context.py::active_mesh``): ``Dense`` and
``Embedding`` split over ``model`` by ``parallel/sharding.py::
shard_model_`` sum or gather their results over the axis; the attention
folds the rank's coordinates into its kernel's dropout seed as the JAX
package's ``fused_attention_sharded_general`` does, and ``ring`` runs ring
attention over ``seq``; hash dropout offsets its element index by the
rank's first row of the global batch, so a data-parallel step draws what
one process draws for the whole batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_attention import (
    _keep_threshold,
    _mul32,
    fused_attention_general,
    fused_attention_sharded_general,
    relpos_attention,
)
from ..ops.hash_dropout import hash_dropout
from ..ops.ring_attention import ring_attention
from ..ops.masks import padding_bias
from ..parallel.collectives import copy_to, gather_from, reduce_from, split_to
from ..parallel.context import get_active_mesh
from ..utils.debug import annotate

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)
PE_MAX_LEN = 5000
_SEED_HI = 2**31 - 1  # seeds drawn in [0, 2**31 - 1), as jax.random.randint


def draw_seed(rng: torch.Generator) -> int:
    """One dropout call's 31-bit seed, drawn on the CPU (no device sync)."""
    return int(torch.randint(0, _SEED_HI, (), generator=rng))


def hash_keep_mask(seed: int, shape, rate: float, dtype, device, offset: int = 0) -> torch.Tensor:
    """Keep mask scaled by 1/(1-rate) in ``dtype``: the murmur finalizer of
    (flat element index + ``offset``, seed), bit-exact with the JAX
    package's ``ConfigurableDropout(impl="hash")`` (uint32 arithmetic
    emulated in int64 with ``_mul32``). ``offset`` is the index of the
    tensor's first element in the global tensor it is a part of."""
    n = int(np.prod(shape))
    idx = _index_term(n, torch.device(device))
    if offset:
        with annotate("sync.dropout.offset_to_device"):  # a pageable copy
            offset_t = torch.tensor(offset & 0xFFFFFFFF, device=device)
        idx = (idx + _mul32(offset_t, 0x9E3779B9)) & 0xFFFFFFFF
    with annotate("sync.dropout.seed_to_device"):
        seed_t = torch.tensor(int(seed) & 0xFFFFFFFF, dtype=torch.int64, device=device)
    h = idx ^ _mul32(seed_t, 0xC2B2AE35)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    keep = (h >= _keep_threshold(rate)).to(dtype).reshape(shape)
    with annotate("sync.dropout.scale_to_device"):
        scale = torch.tensor(1.0 - rate, dtype=dtype, device=device)
    return keep / scale


@functools.lru_cache(maxsize=8)
def _index_term(n: int, device: torch.device) -> torch.Tensor:
    """(i * 0x9E3779B9) mod 2**32 for i < n, built once per size."""
    return _mul32(torch.arange(n, dtype=torch.int64, device=device), 0x9E3779B9)


def data_index() -> int:
    """This rank's index on the active mesh's ``data`` axis."""
    mesh = get_active_mesh()
    return 0 if mesh is None else mesh.index("data")


class ConfigurableDropout(nn.Module):
    """Dropout with a selectable mask generator (``impl``): ``"rng"``
    draws a Bernoulli mask from a generator seeded per call, ``"hash"``
    hashes the flat element index with a per-call seed exactly as the JAX
    package does: on CUDA tensors in one kernel, K10
    (``ops/hash_dropout.py``), on the CPU by ``hash_keep_mask``, its plain
    version. Identity when ``rng`` is None or the rate is 0.

    Under a data mesh ``x`` is this rank's rows of a global batch of equal
    shares: the hash index starts at the rank's first global element, and
    the rng draw folds in the rank. ``heads`` = (index, count) says that
    ``x``'s second dimension is chunk ``index`` of ``count`` (heads split
    over ``model``): the hash then indexes the whole heads dimension."""

    def __init__(self, rate: float, impl: str = "rng"):
        super().__init__()
        if impl not in ("rng", "hash"):
            raise ValueError(f"unknown dropout_impl {impl!r}")
        self.rate, self.impl = float(rate), impl

    def forward(self, x: torch.Tensor, rng, heads=None) -> torch.Tensor:
        if rng is None or self.rate == 0.0:
            return x
        seed = draw_seed(rng)
        d = data_index()
        if self.impl == "hash":
            if x.is_cuda:  # K10: no mask, and nothing copied to the card
                tp = 1 if heads is None else heads[1]
                return hash_dropout(x, seed, self.rate, d * x.numel() * tp, heads)
            if heads is None or heads[1] == 1:
                return x * hash_keep_mask(seed, x.shape, self.rate, x.dtype, x.device,
                                          d * x.numel())
            m, tp = heads
            full = (x.shape[0], x.shape[1] * tp, *x.shape[2:])
            keep = hash_keep_mask(seed, full, self.rate, x.dtype, x.device, d * x.numel() * tp)
            return x * keep.chunk(tp, 1)[m]
        gen = torch.Generator(device=x.device).manual_seed(seed + (d << 32))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.rate
        with annotate("sync.dropout.scale_to_device"):
            scale = torch.tensor(1.0 - self.rate, dtype=x.dtype, device=x.device)
        return x * keep.to(x.dtype) / scale


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``dtype``: input, weight and bias are
    cast at use (flax ``nn.Dense(dtype=...)`` with float32 parameters).

    ``tp`` (set by ``parallel/sharding.py::shard_model_``): "column" holds
    a chunk of the output features (the input's gradient is summed over
    the model axis), "row" a chunk of the input features (the partial
    products are summed over the axis, then the whole bias added)."""

    tp = None

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.tp is not None:
            return self._forward_split(x)
        dt = self.compute_dtype
        if x.dtype == self.weight.dtype == dt:
            # weights already cast (the serving path): no cast calls on the
            # host-bound decode step
            return F.linear(x, self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)

    def _forward_split(self, x):
        dt, tp = self.compute_dtype, self.tp
        bias = None if self.bias is None else self.bias.to(dt)
        if tp.mode == "column":
            return F.linear(copy_to(x, tp.group).to(dt), self.weight.to(dt), bias)
        y = reduce_from(F.linear(x.to(dt), self.weight.to(dt)), tp.group)
        return y if bias is None else y + bias


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and affine in f32,
    output in ``dtype``; epsilon 1e-6."""

    def __init__(self, d_model: int, dtype=torch.float32):
        super().__init__(d_model, eps=LN_EPS)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        if x.dtype == self.weight.dtype == dt:
            # one launch (the host-bound decode step has many LayerNorms);
            # torch accumulates in f32 here too
            return F.layer_norm(x, self.normalized_shape, self.weight, self.bias, self.eps)
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
            self.eps,
        )
        return y.to(dt)


class Embedding(nn.Embedding):
    """Embedding table cast to ``dtype`` at lookup (flax ``nn.Embed``).

    ``tp`` "vocab" (set by ``shard_model_``): the table holds rows
    [index * V/n, (index + 1) * V/n). A lookup takes the ids in that range
    and sums over the model axis; the tied projection's logits of the
    rows are gathered whole over the axis."""

    tp = None

    def __init__(self, num: int, dim: int, dtype=torch.float32):
        super().__init__(num, dim)
        self.compute_dtype = dtype

    def forward(self, ids):
        tp = self.tp
        if tp is None:
            return F.embedding(ids, self.weight.to(self.compute_dtype))
        rows = self.weight.shape[0]
        local = ids - tp.index * rows
        inside = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                          self.weight.to(self.compute_dtype))
        return reduce_from(out * inside[..., None].to(out.dtype), tp.group)

    def attend(self, x):
        """Tied output projection: x @ table^T in the compute dtype."""
        dt = self.compute_dtype
        if self.tp is not None:
            logits = copy_to(x, self.tp.group).to(dt) @ self.weight.to(dt).t()
            return gather_from(logits, self.tp.group, -1)
        if x.dtype == self.weight.dtype == dt:
            return x @ self.weight.t()
        return x.to(dt) @ self.weight.to(dt).t()


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


def relpos_table(t: int, d_model: int, device) -> torch.Tensor:
    """(2T - 1, d) float32 relative-position table of ESPnet's
    ``RelPositionalEncoding`` (``latest``): row r holds the sinusoid of
    position T - 1 - r, sin on even dims and cos on odd dims; rows T - 1 -
    ... - (T - 1) are ``sinusoid_table``'s rows T - 1 ... 0 with the sin
    dims of the negative positions negated."""
    pos = np.arange(t - 1, -t, -1)[:, None].astype(np.float64)
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / d_model)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle)).astype(np.float32)
    return torch.from_numpy(table).to(device)


class PositionalEncoding(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Add table rows [offset, offset + T). The start is clamped so the
        rows fit the table, as ``jax.lax.dynamic_slice_in_dim`` clamps it
        in the JAX package's ``Encoder.encode_chunk``."""
        table = pe_table(self.d_model, x.device)
        f = x.shape[1]
        start = max(0, min(int(offset), PE_MAX_LEN - f))
        return x + table[None, start : start + f].to(x.dtype)


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA with additive-bias masking and explicit cache
    (temperature sqrt(d_k); residual + LN is the caller's). Dropout on the
    attention weights (``weight_dropout``) and on the output."""

    def __init__(
        self, num_heads: int, d_model: int, head_dim: int,
        dropout_rate: float = 0.0, weight_dropout: bool = True,
        dropout_impl: str = "rng", dtype=torch.float32,
    ):
        super().__init__()
        self.num_heads, self.d_model, self.head_dim = num_heads, d_model, head_dim
        self.dropout_rate, self.weight_dropout = float(dropout_rate), weight_dropout
        inner = num_heads * head_dim
        self.q_proj = Dense(d_model, inner, dtype)
        self.k_proj = Dense(d_model, inner, dtype)
        self.v_proj = Dense(d_model, inner, dtype)
        self.out_proj = Dense(inner, d_model, dtype)
        self.attn_drop = ConfigurableDropout(dropout_rate, dropout_impl)
        self.out_drop = ConfigurableDropout(dropout_rate, dropout_impl)

    @property
    def scale(self) -> float:
        return 1.0 / float(np.sqrt(self.head_dim))

    @property
    def local_heads(self) -> int:
        """The heads this rank computes (all of them unless split over
        ``model``)."""
        return self.q_proj.weight.shape[0] // self.head_dim

    def _head_shard(self):
        """(index, count) of this rank's chunk of the heads, or None."""
        tp = self.q_proj.tp
        return None if tp is None else (tp.index, tp.size)

    def _split(self, y: torch.Tensor) -> torch.Tensor:
        """(B, T, H*d) -> (B, T, H, d)."""
        return y.reshape(*y.shape[:-1], self.local_heads, self.head_dim)

    def _merge_out(self, out: torch.Tensor) -> torch.Tensor:
        """(B, T, H, d) -> output projection (B, T, D)."""
        return self.out_proj(out.reshape(*out.shape[:-2], -1))

    def kv(self, kv_in: torch.Tensor):
        """Project keys/values once (cross-attention caches)."""
        return self._split(self.k_proj(kv_in)), self._split(self.v_proj(kv_in))

    def _attend(self, q, k, v, bias, rng=None):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * self.scale
        if bias is not None:
            logits = logits + bias
        weights = torch.softmax(logits, dim=-1).to(v.dtype)
        if self.weight_dropout:
            weights = self.attn_drop(weights, rng, heads=self._head_shard())
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out_drop(self._merge_out(out), rng)

    def forward(self, q_in, kv_in, bias, rng=None):
        q = self._split(self.q_proj(q_in))
        k, v = self.kv(kv_in)
        return self._attend(q, k, v, bias, rng)

    def _fused_general(self, q_in, kv_in, q_lengths, k_lengths, causal, rng, band=0,
                       weight_dropout=True):
        """Project, run the fused attention kernels on (B, H, T, d) with the
        weight dropout in the kernel (unless ``weight_dropout`` is False),
        project out, output dropout."""
        q = self._split(self.q_proj(q_in))
        k, v = self.kv(kv_in)
        to_bhtd = lambda a: a.transpose(1, 2).contiguous()
        rate, seed = 0.0, 0
        if (rng is not None and weight_dropout and self.weight_dropout
                and self.dropout_rate > 0.0):
            rate, seed = self.dropout_rate, draw_seed(rng)
        args = (to_bhtd(q), to_bhtd(k), to_bhtd(v), q_lengths, k_lengths,
                seed, self.scale, rate, causal, band)
        mesh = get_active_mesh()
        if mesh is not None:
            out = fused_attention_sharded_general(
                mesh, *args, heads_split=self.q_proj.tp is not None)
        else:
            out = fused_attention_general(*args)
        return self.out_drop(self._merge_out(out.transpose(1, 2)), rng)

    def fused(self, x, lengths, rng=None):
        """Self-attention through the fused kernel (``attn_impl='fused'``)."""
        return self._fused_general(x, x, lengths, lengths, False, rng)

    def flash(self, x, lengths, rng=None):
        """Self-attention of ``attn_impl='flash'``: the JAX package's flash
        path (the JAX library's TPU kernel) drops no attention weight and
        keeps the output dropout; here the fused kernels K1/K2 at weight
        dropout 0. Keys are masked by length here and by segment ids there,
        which lets a padded query row see the padded keys: the two differ on
        padded query rows only, which no valid output reads."""
        return self._fused_general(x, x, lengths, lengths, False, rng, weight_dropout=False)

    def fused_pattern(self, x, lengths, causal: bool, band: int, rng=None):
        """Self-attention through the fused kernel with the banded /
        causal(-banded) pattern applied in the kernel."""
        return self._fused_general(x, x, lengths, lengths, causal, rng, band=band)

    def fused_causal(self, x, lengths, rng=None):
        """Decoder causal self-attention through the fused kernel (kpos <=
        qpos plus the target-length mask)."""
        return self._fused_general(x, x, lengths, lengths, True, rng)

    def fused_cross(self, q_in, kv_in, q_lengths, k_lengths, rng=None):
        """Decoder cross-attention through the fused kernel: rectangular
        tiles, queries masked by target length, keys by encoder length."""
        return self._fused_general(q_in, kv_in, q_lengths, k_lengths, False, rng)

    def ring(self, x, lengths, rng=None):
        """Self-attention of ``attn_impl="ring"``: ring attention over the
        active mesh's ``seq`` axis (``ops/ring_attention.py``). With no
        ``seq`` axis, the plain masked path. T is padded to a multiple of
        the axis' size (padded keys are masked by length); each rank takes
        its T / seq query rows and K/V block, and the blocks of the output
        are gathered whole. No attention-weight dropout (as ``flash``);
        the output dropout stays."""
        mesh = get_active_mesh()
        sp = 1 if mesh is None else mesh.shape["seq"]
        q = self._split(self.q_proj(x))
        k, v = self.kv(x)
        if sp == 1:
            return self._attend(q, k, v, padding_bias(lengths, x.shape[1]), rng)
        group = mesh.group("seq")
        t = x.shape[1]
        t_pad = -(-t // sp) * sp
        if t_pad != t:
            pad = (0, 0, 0, 0, 0, t_pad - t)
            q, k, v = F.pad(q, pad), F.pad(k, pad), F.pad(v, pad)
        q, k, v = (split_to(a, group, 1) for a in (q, k, v))
        out = ring_attention(q, k, v, lengths.to(x.device), group, self.scale)
        out = gather_from(out, group, 1)[:, :t].to(self.out_proj.compute_dtype)
        return self.out_drop(self._merge_out(out), rng)

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
        h, dk = self.local_heads, self.head_dim
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
        h, dk = self.local_heads, self.head_dim
        qb = q.reshape(b, k_beam, h, dk)
        s = torch.einsum("bkhd,bthd->bhkt", qb.float(), kc.float()) * self.scale
        if bias is not None:
            s = s + bias  # (B, 1, 1, T) broadcasts over (B, H, K, T)
        w = torch.softmax(s, dim=-1).to(vc.dtype)
        out = torch.einsum("bhkt,bthd->bkhd", w, vc)
        return self._merge_out(out.reshape(b * k_beam, 1, h, dk))

    def make_cache(self, batch: int, max_len: int, dtype, device):
        """Heads-major (B, H, T, d) zero caches."""
        shape = (batch, self.local_heads, max_len, self.head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }


class RelPositionMultiHeadAttention(MultiHeadAttention):
    """ESPnet's relative-position self-attention (``RelPositionMulti
    HeadedAttention``, ``rel_pos_type: latest``): the scores add (q + v_h)
    . p_{i-j} to (q + u_h) . k_j, with p the relative table projected by
    ``linear_pos`` (no bias) and u, v learned per head (``pos_bias_u``,
    ``pos_bias_v``, (H, d)). Through ``ops/fused_attention.py::
    relpos_attention`` (K11/K12 on the card). No attention-weight dropout
    (ESPnet's ``attention_dropout_rate`` 0); the output dropout stays.
    Heads split over ``model`` are refused (``linear_pos``, u and v are
    not sharded)."""

    def __init__(
        self, num_heads: int, d_model: int, head_dim: int,
        dropout_rate: float = 0.0, dropout_impl: str = "rng", dtype=torch.float32,
    ):
        super().__init__(num_heads, d_model, head_dim, dropout_rate, weight_dropout=False,
                         dropout_impl=dropout_impl, dtype=dtype)
        self.linear_pos = Dense(d_model, num_heads * head_dim, dtype, bias=False)
        self.pos_bias_u = nn.Parameter(torch.empty(num_heads, head_dim))
        self.pos_bias_v = nn.Parameter(torch.empty(num_heads, head_dim))

    def relpos(self, x, pos, lengths, rng=None):
        """Self-attention of ``x`` (B, T, d) with ``pos`` (2T - 1, H d), the
        relative table dropped out and projected by ``linear_pos`` (the
        encoder projects every block's at once), keys masked by
        ``lengths``. Whatever ``attn_impl`` says, through
        ``relpos_attention``: K11/K12 on CUDA tensors (bf16 only; another
        dtype raises ValueError), the plain versions on the CPU."""
        if self.q_proj.tp is not None:
            raise ValueError("relative-position attention does not split its heads over "
                             "'model': linear_pos, pos_bias_u and pos_bias_v are not sharded")
        q = self._split(self.q_proj(x))
        k, v = self.kv(x)
        dt = q.dtype
        out = relpos_attention(q, k, v, self._split(pos), self.pos_bias_u.to(dt),
                               self.pos_bias_v.to(dt), lengths, self.scale)
        return self.out_drop(self._merge_out(out), rng)


class PositionwiseFFN(nn.Module):
    """d_model -> d_ff -> d_model with ReLU (``activation`` "relu") or
    swish ("swish", the conformer's macaron FFNs in ESPnet), then
    dropout."""

    def __init__(
        self, d_model: int, d_ff: int, dropout_rate: float = 0.0,
        dropout_impl: str = "rng", dtype=torch.float32, activation: str = "relu",
    ):
        super().__init__()
        if activation not in ("relu", "swish"):
            raise ValueError(f"unknown ffn activation {activation!r}")
        self.w1 = Dense(d_model, d_ff, dtype)
        self.w2 = Dense(d_ff, d_model, dtype)
        self.drop = ConfigurableDropout(dropout_rate, dropout_impl)
        self.act = torch.relu if activation == "relu" else F.silu

    def forward(self, x, rng=None):
        return self.drop(self.w2(self.act(self.w1(x))), rng)


class SubLayer(nn.Module):
    """Residual + LayerNorm: ``pre`` is x + f(norm(x)); ``post`` is
    norm(alpha*x + f(x)) (alpha > 1 is DeepNorm's residual scaling)."""

    def __init__(
        self, norm_type: str, d_model: int, alpha: float = 1.0, dtype=torch.float32
    ):
        super().__init__()
        self.norm_type = norm_type
        self.alpha = alpha
        self.norm = LayerNorm(d_model, dtype)

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


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def _ceil_div(n: int, d: int) -> int:
    return -(-n // d)


def keep_cudnn_f32(x: torch.Tensor) -> None:
    """Turn off cuDNN's TF32 for f32 convolutions and recurrences before a
    layer that calls cuDNN runs on the card: PyTorch allows it by default,
    and f32 here means f32, as in flax. The switch is process-wide and the
    backward pass reads it again, so it is set for the process, not around
    the call."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False


def same_padding(n: int, kernel: int, stride: int) -> tuple:
    """flax / XLA ``"SAME"`` padding (lo, hi) of one axis of length ``n``:
    the output has ceil(n / stride) rows and the odd pad goes on the right
    (stride 2, kernel 3: (0, 1) for even n, (1, 1) for odd n)."""
    out = _ceil_div(n, stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


class ConvModule(nn.Module):
    """Conformer convolution module: pointwise (d -> 2d) + GLU -> frame
    mask -> depthwise conv of width k -> LayerNorm -> swish -> pointwise
    (d -> d) -> dropout.

    Padded frames are zeroed in GLU space, before the depthwise conv, so
    no padding reaches a valid frame. ``causal`` pads the conv with k - 1
    zeros on the left only (output t reads inputs t-k+1..t); otherwise the
    padding is flax's ``"SAME"``: (k-1)//2 on the left, the rest on the
    right."""

    def __init__(
        self, d_model: int, kernel_size: int = 15, dropout_rate: float = 0.0,
        causal: bool = False, dropout_impl: str = "rng", dtype=torch.float32,
    ):
        super().__init__()
        self.kernel_size, self.causal = kernel_size, causal
        self.compute_dtype = dtype
        self.pw1 = Dense(d_model, 2 * d_model, dtype)
        self.dw = nn.Conv1d(d_model, d_model, kernel_size, groups=d_model)
        self.norm = LayerNorm(d_model, dtype)
        self.pw2 = Dense(d_model, d_model, dtype)
        self.drop = ConfigurableDropout(dropout_rate, dropout_impl)

    def forward(self, x, lengths=None, rng=None, frame_mask=None):
        """x: (B, T, d). ``frame_mask`` (B, T), 1 on valid frames, is taken
        from ``lengths`` when not given (the chunked encode passes its own)."""
        dt = self.compute_dtype
        keep_cudnn_f32(x)
        if frame_mask is None and lengths is not None:
            frame_mask = (
                torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths.to(x.device)[:, None]
            )
        y = F.glu(self.pw1(x), dim=-1)
        if frame_mask is not None:
            y = y * frame_mask.to(y.dtype)[..., None]
        k = self.kernel_size
        pad = (k - 1, 0) if self.causal else ((k - 1) // 2, k - 1 - (k - 1) // 2)
        y = F.conv1d(
            F.pad(y.transpose(1, 2), pad), _cast(self.dw.weight, dt),
            _cast(self.dw.bias, dt), groups=self.dw.groups,
        ).transpose(1, 2)
        y = self.pw2(F.silu(self.norm(y)))
        return self.drop(y, rng)


class ConvSubsampler(nn.Module):
    """Conv2d frontend: two 3x3 stride-2 convolutions to ``channels``
    channels (0: d/8), each followed by ReLU, over the (T, F) feature
    image, then a projection of the (f, c) features of each frame to d: 4x
    fewer frames. ``padding`` "same" is flax's SAME (ceil(n/2) rows a
    convolution); "valid" is ESPnet's ``Conv2dSubsampling`` ((n - 1) // 2
    rows, no padding), whose frames count as valid where all their inputs
    are. ``n_features`` is F, which fixes the projection's width f * c
    (flax infers it from the data)."""

    def __init__(self, d_model: int, n_features: int, dtype=torch.float32,
                 channels: int = 0, padding: str = "same"):
        super().__init__()
        if padding not in ("same", "valid"):
            raise ValueError(f"unknown frontend padding {padding!r}")
        c = channels or d_model // 8
        self.compute_dtype = dtype
        self.padding = padding
        self.conv0 = nn.Conv2d(1, c, 3, stride=2)
        self.conv1 = nn.Conv2d(c, c, 3, stride=2)
        self.proj = Dense(self.out_rows(n_features) * c, d_model, dtype)

    def out_rows(self, n: int) -> int:
        """Rows left of ``n`` after both convolutions (frames or features)."""
        if self.padding == "valid":
            return ((n - 1) // 2 - 1) // 2
        return _ceil_div(_ceil_div(n, 2), 2)

    def forward(self, x, lengths):
        """x: (B, T, F) -> ((B, T', d), lengths): T' = ceil(ceil(T/2)/2)
        and lengths (l+1)//2 twice (SAME), or ((T-1)//2 - 1)//2 and
        (l-1)//2 twice (valid)."""
        dt = self.compute_dtype
        keep_cudnn_f32(x)
        y = _cast(x, dt)[:, None]  # (B, 1, T, F)
        for conv in (self.conv0, self.conv1):
            if self.padding == "same":
                t_lo, t_hi = same_padding(y.shape[2], 3, 2)
                f_lo, f_hi = same_padding(y.shape[3], 3, 2)
                y = F.pad(y, (f_lo, f_hi, t_lo, t_hi))
            y = torch.relu(F.conv2d(y, _cast(conv.weight, dt), _cast(conv.bias, dt),
                                    stride=2))
        b, c, t, f = y.shape
        # flax flattens (B, t, f, c): the channel varies fastest
        y = self.proj(y.permute(0, 2, 3, 1).reshape(b, t, f * c))
        shift = 1 if self.padding == "same" else -1
        for _ in range(2):
            lengths = (lengths + shift) // 2
        return y, lengths
