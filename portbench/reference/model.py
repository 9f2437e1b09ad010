"""Plain Speech-Transformer: the encoder (linear LFR frontend, sinusoidal
positions, post- or pre-LN self-attention layers with a ReLU FFN), the
decoder (tied embedding scaled by sqrt(d), causal self-attention,
cross-attention, FFN, the tied output projection) and the CTC head, as
functions of a weight dict named as the benchmark makes it.

Dropout follows the configuration's recipe exactly, so that a training
step can be followed: each dropout site draws a 31-bit seed from the step's
CPU generator in the forward's order (the encoder input; per encoder layer
the attention weights, the attention output, the FFN output; the decoder
input; per decoder layer self-attention weights and output, cross-attention
weights and output, the FFN output), and keeps an element where the
murmur3 finalizer of its index and the seed reaches the rate's threshold.
The encoder's attention weights are hashed at (query, key, seed, batch x
heads + head); every other site at the element's flat index. Kept
elements are scaled by 1 / (1 - rate)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import Precision

NEG = -1e9
LN_EPS = 1e-6
M32 = 0xFFFFFFFF
BOS, EOS, PAD = 2, 3, 0


# -- the dropout hash ------------------------------------------------------


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 tensors of uint32 values."""
    lo, hi = x & 0xFFFF, x >> 16
    return ((lo * c) + (((hi * c) & 0xFFFF) << 16)) & M32


def _finalize(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def flat_keep(seed: int, shape, rate: float, device) -> torch.Tensor:
    """float32 keep mask scaled by 1/(1-rate), hashed at the flat index."""
    n = int(np.prod(shape))
    idx = mul32(torch.arange(n, dtype=torch.int64, device=device), 0x9E3779B9)
    h = _finalize(idx ^ mul32(torch.tensor(seed & M32, device=device), 0xC2B2AE35))
    return ((h >= _threshold(rate)).float() / (1.0 - rate)).reshape(shape)


def attention_keep(seed: int, b: int, heads: int, tq: int, tk: int, rate: float,
                   device) -> torch.Tensor:
    """(B, H, Tq, Tk) float32 keep mask hashed at (query, key, seed, cell)."""
    cell = (torch.arange(b, device=device)[:, None] * heads
            + torch.arange(heads, device=device)[None, :])
    base = (mul32(torch.tensor(seed & M32, device=device), 0xC2B2AE35)
            + mul32(cell, 0x27D4EB2F)) & M32
    i = torch.arange(tq, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(tk, dtype=torch.int64, device=device)[None, :]
    x = mul32(i, 0x9E3779B9) ^ mul32(j, 0x85EBCA6B)
    h = _finalize(x[None, None] ^ base[:, :, None, None])
    return (h >= _threshold(rate)).float() / (1.0 - rate)


class Dropout:
    """The step's dropout: ``gen`` (a CPU generator) or None for none."""

    def __init__(self, rate: float, gen: torch.Generator | None):
        self.rate, self.gen = float(rate), gen

    @property
    def on(self) -> bool:
        return self.gen is not None and self.rate > 0.0

    def seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.gen))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.on:
            return x
        return x * flat_keep(self.seed(), x.shape, self.rate, x.device)


# -- layers ----------------------------------------------------------------


def layer_norm(x, w, b):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), w, b, LN_EPS)


def positions(t: int, d: int, device) -> torch.Tensor:
    pos = np.arange(t)[:, None].astype(np.float64)
    i = np.arange(d)[None, :]
    ang = pos / np.power(10000.0, 2 * (i // 2) / d)
    table = np.where(i % 2 == 0, np.sin(ang), np.cos(ang)).astype(np.float32)
    return torch.from_numpy(table).to(device)


class Model:
    """The reference for one model configuration (the ``model`` section of
    a configuration file) over weights ``w``; ``prec`` rounds the products'
    operands (``Precision``)."""

    def __init__(self, model: dict, w: dict, prec: Precision | None = None):
        self.cfg, self.w = model, w
        self.p = prec or Precision("f32")
        self.d = model["d_model"]
        self.h, self.dk = model["num_heads"], model["head_dim"]
        self.pre = model.get("norm_type", "post") == "pre"

    def dense(self, x, name):
        return self.p.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def norm(self, x, name):
        return layer_norm(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def sublayer(self, x, name, fn):
        if self.pre:
            return x + fn(self.norm(x, name))
        return self.norm(x + fn(x), name)

    def attention(self, name, xq, xkv, allow, drop: Dropout, pair_hash: bool):
        """``allow`` (B|1, 1, Tq|1, Tk) bool; the weights' dropout is hashed
        at (query, key) pairs (``pair_hash``) or at the flat index."""
        b, tq, _ = xq.shape
        tk = xkv.shape[1]
        split = lambda y, t: y.reshape(b, t, self.h, self.dk).transpose(1, 2)
        q = split(self.dense(xq, f"{name}.q_proj"), tq)
        k = split(self.dense(xkv, f"{name}.k_proj"), tk)
        v = split(self.dense(xkv, f"{name}.v_proj"), tk)
        s = self.p.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(self.dk)
        s = s + torch.where(allow, 0.0, NEG)
        wts = torch.softmax(s, dim=-1)
        if drop.on:
            seed = drop.seed()
            keep = (attention_keep(seed, b, self.h, tq, tk, drop.rate, xq.device)
                    if pair_hash else flat_keep(seed, wts.shape, drop.rate, xq.device))
            wts = wts * keep
        out = self.p.einsum("bhqk,bhkd->bhqd", wts, v).transpose(1, 2).reshape(b, tq, -1)
        return drop(self.dense(out, f"{name}.out_proj"))

    def ffn(self, x, name, drop: Dropout):
        return drop(self.dense(torch.relu(self.dense(x, f"{name}.w1")), f"{name}.w2"))

    # -- the encoder and its heads -------------------------------------------

    def encode(self, feats, lengths, drop: Dropout | None = None):
        drop = drop or Dropout(0.0, None)
        t = feats.shape[1]
        x = self.norm(self.dense(feats, "encoder.input_proj"), "encoder.input_norm")
        x = drop(x + positions(t, self.d, x.device))
        keys = (torch.arange(t, device=x.device)[None, :] < lengths[:, None])
        allow = keys[:, None, None, :]
        for i in range(self.cfg["num_encoder_layers"]):
            p = f"encoder.layers.{i}"
            x = self.sublayer(x, f"{p}.sub1.norm",
                              lambda y: self.attention(f"{p}.attn", y, y, allow, drop, True))
            x = self.sublayer(x, f"{p}.sub2.norm", lambda y: self.ffn(y, f"{p}.ffn", drop))
        if self.pre:
            x = self.norm(x, "encoder.final_norm")
        return x, lengths

    def ctc_logits(self, enc):
        return self.dense(enc, "ctc_head")

    # -- the decoder -----------------------------------------------------------

    def decode(self, ys_in, ys_lengths, enc, enc_lengths, drop: Dropout | None = None):
        """Teacher-forced logits (B, L, V) over the prefixes ``ys_in``."""
        drop = drop or Dropout(0.0, None)
        b, t = ys_in.shape
        dev = ys_in.device
        emb = self.w["decoder.embed.weight"]
        x = emb[ys_in] * float(np.float32(np.sqrt(self.d)))
        x = drop(x + positions(t, self.d, dev))
        pos = torch.arange(t, device=dev)
        self_allow = ((pos[None, :] <= pos[:, None])[None]
                      & (pos[None, None, :] < ys_lengths[:, None, None]))[:, None]
        te = enc.shape[1]
        cross_allow = (torch.arange(te, device=dev)[None, :] < enc_lengths[:, None])[:, None, None]
        for i in range(self.cfg["num_decoder_layers"]):
            p = f"decoder.layers.{i}"
            x = self.sublayer(x, f"{p}.sub1.norm", lambda y: self.attention(
                f"{p}.self_attn", y, y, self_allow, drop, False))
            x = self.sublayer(x, f"{p}.sub2.norm", lambda y: self.attention(
                f"{p}.cross_attn", y, enc, cross_allow, drop, False))
            x = self.sublayer(x, f"{p}.sub3.norm", lambda y: self.ffn(y, f"{p}.ffn", drop))
        if self.pre:
            x = self.norm(x, "decoder.final_norm")
        return self.p.linear(x, emb)

    # -- the training forward ----------------------------------------------

    def forward(self, feats, lengths, labels, label_lengths, drop: Dropout):
        """(enc, enc_lengths, ctc logits or None, decoder logits, gold)."""
        enc, enc_len = self.encode(feats, lengths, drop)
        ys_in, gold = targets(labels, label_lengths)
        logits = self.decode(ys_in, label_lengths + 1, enc, enc_len, drop)
        ctc = self.ctc_logits(enc) if "ctc_head.weight" in self.w else None
        return enc, enc_len, ctc, logits, gold


def targets(labels: torch.Tensor, label_lengths: torch.Tensor):
    """([BOS] + labels, labels + [EOS]), PAD-padded to L + 1."""
    b, l = labels.shape
    dev = labels.device
    ys_in = torch.cat([torch.full((b, 1), BOS, dtype=labels.dtype, device=dev), labels], 1)
    gold = torch.cat([labels, torch.zeros((b, 1), dtype=labels.dtype, device=dev)], 1)
    at_end = torch.arange(l + 1, device=dev)[None, :] == label_lengths[:, None]
    return ys_in, torch.where(at_end, torch.full_like(gold, EOS), gold)
