"""Speech-Transformer encoder/decoder with optional CTC head, in torch.

Counterpart of ``asr_chinese_e2e_tpu/models/transformer.py``: the
teacher-forced training forward (with dropout), encode, the exact chunked
encode of the streaming (causal-banded) encoder, the uncached and
KV-cached decoder, and the CTC head; the encoder's and the decoder's
attention through the fused kernels (``attn_impl`` / ``decoder_attn_impl``
= "fused") or plain products ("xla"). Both encoder families
(``encoder_type`` "transformer" or "conformer"), both frontends
(``frontend`` "linear" or "conv2d"), ``remat`` (per-layer activation
recomputation, ``torch.utils.checkpoint``) and ``attn_impl="flash"``
(the fused kernels without weight dropout) are ported. The ring
attention path is not ported yet; asking for it raises
``NotImplementedError`` naming the ROADMAP item.

Weights are created from an explicit ``torch.Generator`` (the JAX
package draws them from a PRNG key), or converted from flax with
``models/convert.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.config import Config
from ..data.vocab import BOS_ID, EOS_ID, PAD_ID
from ..ops.masks import (
    NEG_INF,
    banded_bias,
    causal_banded_bias,
    causal_bias,
    causal_padding_bias,
    padding_bias,
)
from .layers import (
    ConfigurableDropout,
    ConvModule,
    ConvSubsampler,
    Dense,
    Embedding,
    LayerNorm,
    MultiHeadAttention,
    PositionalEncoding,
    PositionwiseFFN,
    SubLayer,
    pe_table,
)


def default_config() -> Config:
    """TransformerOffical defaults (``transformer_official.py:112-124``)."""
    return Config(
        d_model=512,
        num_heads=8,
        head_dim=64,
        d_ff=1024,
        num_encoder_layers=6,
        num_decoder_layers=6,
        dropout_rate=0.1,
        norm_type="post",
        input_dim=320,
        frontend="linear",
        attention_band=0,
        causal_encoder=False,
        encoder_type="transformer",
        conv_kernel_size=15,
        attn_impl="xla",
        decoder_attn_impl="xla",
        attn_weight_dropout=True,
        dropout_impl="rng",
        deepnorm=False,
        ctc_weight=0.0,
        label_smoothing=0.0,
        max_target_len=128,
        dtype="float32",
    )


def deepnorm_coeffs(cfg):
    """DeepNorm ((enc_alpha, enc_beta), (dec_alpha, dec_beta)); all 1.0
    when ``deepnorm`` is off or the placement is pre-LN."""
    if not cfg.get("deepnorm", False) or cfg.get("norm_type", "post") != "post":
        return (1.0, 1.0), (1.0, 1.0)
    n = cfg.num_encoder_layers
    m = cfg.get("num_decoder_layers", 0)
    if m == 0:  # encoder-only prescription
        return ((2.0 * n) ** 0.25, (8.0 * n) ** -0.25), (1.0, 1.0)
    enc = (0.81 * (n**4 * m) ** (1.0 / 16), 0.87 * (n**4 * m) ** (-1.0 / 16))
    dec = ((3.0 * m) ** 0.25, (12.0 * m) ** -0.25)
    return enc, dec


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for configurations the port does not
    run yet, naming the ROADMAP item that brings them."""
    if cfg.get("attn_impl", "xla") == "ring":
        raise NotImplementedError(
            "attn_impl='ring' (ROADMAP §1, item 7: parallelism) is not ported yet"
        )
    if cfg.get("attn_impl", "xla") not in ("xla", "fused", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    if cfg.get("decoder_attn_impl", "xla") not in ("xla", "fused"):
        raise ValueError(f"unknown decoder_attn_impl {cfg.decoder_attn_impl!r}")
    if cfg.get("encoder_type", "transformer") not in ("transformer", "conformer"):
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
    if cfg.get("frontend", "linear") not in ("linear", "conv2d"):
        raise ValueError(f"unknown frontend {cfg.frontend!r}")


def is_conformer(cfg) -> bool:
    return cfg.get("encoder_type", "transformer") == "conformer"


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.get("dtype") == "bfloat16" else torch.float32


def _attention(cfg) -> MultiHeadAttention:
    return MultiHeadAttention(
        cfg.num_heads, cfg.d_model, cfg.head_dim, cfg.dropout_rate,
        weight_dropout=cfg.get("attn_weight_dropout", True),
        dropout_impl=cfg.get("dropout_impl", "rng"), dtype=compute_dtype_of(cfg),
    )


def _ffn(cfg) -> PositionwiseFFN:
    return PositionwiseFFN(
        cfg.d_model, cfg.d_ff, cfg.dropout_rate,
        dropout_impl=cfg.get("dropout_impl", "rng"), dtype=compute_dtype_of(cfg),
    )


def run_layer(layer, remat: bool, rng, *args):
    """``layer(*args, rng)``; with ``remat`` (and a gradient to take) under
    ``torch.utils.checkpoint``, which keeps only the layer's input and
    recomputes its activations in the backward. The recomputation replays
    the layer's dropout draws: the layer runs on a generator restored from
    the state ``rng`` had before it (in the forward and in the recompute
    alike), and ``rng`` is then left where the forward left it, so remat
    on and off draw the same seeds."""
    if not (remat and torch.is_grad_enabled()):
        return layer(*args, rng)
    if rng is None:
        return checkpoint(layer, *args, None, use_reentrant=False)
    start, end = rng.get_state(), []

    def replay(*a):
        gen = torch.Generator()
        gen.set_state(start)
        out = layer(*a, gen)
        if not end:  # the forward, not the recompute
            end.append(gen.get_state())
        return out

    out = checkpoint(replay, *args, use_reentrant=False)
    rng.set_state(end[0])
    return out


def _encoder_self_attention(cfg, attn, x, bias, lengths, rng):
    """Encoder self-attention dispatch on ``attn_impl``: "fused" runs the
    attention kernels (band / causal patterns in the kernel), "flash" the
    same kernels without weight dropout (a band or causal pattern takes
    the plain bias path, as the JAX package's flash kernel has none),
    "xla" the plain masked products."""
    impl = cfg.get("attn_impl", "xla")
    band = cfg.get("attention_band", 0)
    causal = cfg.get("causal_encoder", False)
    if lengths is not None:
        if impl == "fused":
            if band or causal:
                return attn.fused_pattern(x, lengths, causal, band, rng)
            return attn.fused(x, lengths, rng)
        if impl == "flash" and not (band or causal):
            return attn.flash(x, lengths, rng)
    return attn(x, x, bias, rng)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        (alpha, _), _ = deepnorm_coeffs(cfg)
        dt = compute_dtype_of(cfg)
        self.attn = _attention(cfg)
        self.ffn = _ffn(cfg)
        self.sub1 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha, dtype=dt)
        self.sub2 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha, dtype=dt)

    def forward(self, x, bias, lengths=None, rng=None):
        x = self.sub1(
            x,
            lambda y: _encoder_self_attention(self.cfg, self.attn, y, bias, lengths, rng),
        )
        return self.sub2(x, lambda y: self.ffn(y, rng))

    def chunk_step(self, x, tail, bias):
        """Incremental encode step of the streaming (causal-banded) mode.
        ``x``: (B, F, D) the new chunk's layer input; ``tail``: (B, w, D)
        this layer's input for the previous ``w`` frames; ``bias``: (1, 1,
        F, w+F) from ``Encoder.encode_chunk``. Queries are the F new frames,
        keys/values the tail + new frames: the offline causal-banded pass
        restricted to the new rows."""
        if self.cfg.norm_type == "pre":
            qn = self.sub1.norm(x)
            kv = torch.cat([self.sub1.norm(tail), qn], dim=1)
            x = x + self.attn(qn, kv, bias)
            return x + self.ffn(self.sub2.norm(x))
        kv = torch.cat([tail, x], dim=1)
        a1, a2 = self.sub1.alpha, self.sub2.alpha
        x = self.sub1.norm(a1 * x + self.attn(x, kv, bias))
        return self.sub2.norm(a2 * x + self.ffn(x))


class ConformerBlock(nn.Module):
    """Conformer block: half-step FFN, self-attention, convolution module,
    half-step FFN, each pre-normed and residual, then a final LayerNorm
    (pre-LN whatever ``norm_type``, which still governs the decoder). The
    depthwise conv is causal exactly when the encoder is
    (``causal_encoder``), so it reads no future frame."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype_of(cfg)
        self.ffn1 = _ffn(cfg)
        self.ffn2 = _ffn(cfg)
        self.attn = _attention(cfg)
        self.conv = ConvModule(
            cfg.d_model, cfg.get("conv_kernel_size", 15), cfg.dropout_rate,
            causal=cfg.get("causal_encoder", False),
            dropout_impl=cfg.get("dropout_impl", "rng"), dtype=dt,
        )
        self.ln_ffn1 = LayerNorm(cfg.d_model, dt)
        self.ln_attn = LayerNorm(cfg.d_model, dt)
        self.ln_conv = LayerNorm(cfg.d_model, dt)
        self.ln_ffn2 = LayerNorm(cfg.d_model, dt)
        self.ln_final = LayerNorm(cfg.d_model, dt)

    def forward(self, x, bias, lengths=None, rng=None):
        # dropout draws in the JAX block's order: ffn1, attn, conv, ffn2
        x = x + 0.5 * self.ffn1(self.ln_ffn1(x), rng)
        x = x + _encoder_self_attention(
            self.cfg, self.attn, self.ln_attn(x), bias, lengths, rng
        )
        x = x + self.conv(self.ln_conv(x), lengths, rng)
        x = x + 0.5 * self.ffn2(self.ln_ffn2(x), rng)
        return self.ln_final(x)

    def chunk_step(self, x, tail, conv_carry, bias, carry_mask):
        """Incremental encode step of the streaming conformer. ``tail`` (B,
        w, D): the block inputs of the previous w frames (their half-step
        FFN is recomputed: it is pointwise); ``conv_carry`` (B, k-1, D):
        the conv module's inputs (residual stream after attention) of the
        previous k-1 frames; ``carry_mask`` (1, k-1): 1 where a carry row's
        global frame index is >= 0. The zero carry is zero in residual
        space, not in GLU space, so those rows are masked after pw1/GLU,
        where the offline conv reads its zero padding. Returns (out (B, F,
        D), new conv carry)."""
        kc = conv_carry.shape[1]
        tail1 = tail + 0.5 * self.ffn1(self.ln_ffn1(tail))
        x1 = x + 0.5 * self.ffn1(self.ln_ffn1(x))
        qn = self.ln_attn(x1)
        kv = torch.cat([self.ln_attn(tail1), qn], dim=1)
        x2 = x1 + self.attn(qn, kv, bias)
        conv_in = torch.cat([conv_carry, x2], dim=1)
        b, f = x.shape[:2]
        fmask = torch.cat(
            [carry_mask.expand(b, kc), carry_mask.new_ones((b, f))], dim=1
        )
        y = self.conv(self.ln_conv(conv_in), frame_mask=fmask)
        x3 = x2 + y[:, kc:]
        x4 = x3 + 0.5 * self.ffn2(self.ln_ffn2(x3))
        return self.ln_final(x4), conv_in[:, -kc:]


def init_chunk_state(cfg, batch: int, device=None):
    """Zero left-context carries for ``Encoder.encode_chunk``, in the
    compute dtype on ``device``, one per layer: a (B, band, d) input tail
    (zero rows are never attended: ``encode_chunk`` masks keys with a
    negative global index); for the conformer a dict of that ``"tail"``
    and a (B, k-1, d) causal-conv input carry ``"conv"`` (its zero rows
    are masked after GLU, see ``ConformerBlock.chunk_step``)."""
    dt = compute_dtype_of(cfg)

    def zeros(rows):
        return torch.zeros((batch, rows, cfg.d_model), dtype=dt, device=device)

    if is_conformer(cfg):
        kc = cfg.get("conv_kernel_size", 15) - 1
        return [
            {"tail": zeros(cfg.attention_band), "conv": zeros(kc)}
            for _ in range(cfg.num_encoder_layers)
        ]
    return [zeros(cfg.attention_band) for _ in range(cfg.num_encoder_layers)]


class Encoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype_of(cfg)
        if cfg.get("frontend", "linear") == "conv2d":
            # input_dim is the feature width F here (see main.train)
            self.frontend_mod = ConvSubsampler(cfg.d_model, cfg.input_dim, dt)
        else:
            self.input_proj = Dense(cfg.input_dim, cfg.d_model, dt)
            self.input_norm = LayerNorm(cfg.d_model, dt)
        self.pe = PositionalEncoding(cfg.d_model)
        self.dropout = ConfigurableDropout(cfg.dropout_rate, cfg.get("dropout_impl", "rng"))
        layer_cls = ConformerBlock if is_conformer(cfg) else EncoderLayer
        self.layers = nn.ModuleList(layer_cls(cfg) for _ in range(cfg.num_encoder_layers))
        # a conformer block ends in its own LayerNorm: the extra pre-LN
        # output norm is the transformer stack's only
        self.final_norm = (
            LayerNorm(cfg.d_model, dt)
            if cfg.norm_type == "pre" and not is_conformer(cfg) else None
        )

    def _frontend(self, feats, feat_lengths):
        """(B, T, F) features -> ((B, T', d), frame lengths): the linear
        frontend keeps T, the conv2d one subsamples it 4x."""
        if self.cfg.get("frontend", "linear") == "conv2d":
            return self.frontend_mod(feats, feat_lengths)
        return self.input_norm(self.input_proj(feats)), feat_lengths

    def forward(self, feats, feat_lengths, rng=None):
        """Returns (enc_out (B, T', d), its lengths): T' and the lengths
        are the frontend's (subsampled by the conv2d frontend)."""
        c = self.cfg
        x, feat_lengths = self._frontend(feats, feat_lengths)
        x = self.dropout(self.pe(x), rng)
        t, dev = x.shape[1], x.device
        bias = padding_bias(feat_lengths, t)
        band = c.get("attention_band", 0)
        if c.get("causal_encoder", False):
            bias = bias + (
                causal_banded_bias(t, band, dev) if band else causal_bias(t, dev)
            )
        elif band:
            bias = bias + banded_bias(t, band, dev)
        remat = c.get("remat", False)
        for layer in self.layers:
            x = run_layer(layer, remat, rng, x, bias, feat_lengths)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, feat_lengths

    # -- streaming: exact chunked incremental encoding ----------------------
    def init_chunk_tails(self, batch: int):
        """Zero left-context carries (see ``init_chunk_state``)."""
        return init_chunk_state(self.cfg, batch, next(self.parameters()).device)

    def encode_chunk(self, feats_chunk, tails, offset: int):
        """Encode F new frames given per-layer left-context carries (see
        ``init_chunk_state``): the exact chunked evaluation of the
        causal-banded encoder (the outputs concatenated over chunks equal
        one full-sequence pass). Needs ``causal_encoder=True``,
        ``attention_band`` w > 0 and the linear frontend; both encoder
        families stream. feats_chunk: (B, F, input_dim); offset: global
        frame index of the chunk's first frame. Returns (enc_chunk (B, F,
        d), new_tails). All F frames are treated as real; causality keeps a
        padded final chunk's padding out of its valid rows."""
        c = self.cfg
        if not (c.get("causal_encoder", False) and c.get("attention_band", 0)):
            raise ValueError("encode_chunk requires causal_encoder=True and attention_band>0")
        if c.get("frontend", "linear") != "linear":
            raise ValueError("encode_chunk requires the linear frontend")
        w = c.attention_band
        x = self.pe(self.input_norm(self.input_proj(feats_chunk)), offset)
        f, dev = x.shape[1], x.device
        # query i sits at global offset+i, key j at offset-w+j: allow
        # 0 <= (global q - global k) <= w and global k >= 0
        qi = torch.arange(f, device=dev)[:, None]
        kj = torch.arange(w + f, device=dev)[None, :]
        rel = (qi + w) - kj
        allow = (rel >= 0) & (rel <= w) & (offset - w + kj >= 0)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        bias = torch.where(allow, zero, NEG_INF)[None, None]
        new_tails = []
        if is_conformer(c):
            kc = c.get("conv_kernel_size", 15) - 1
            # conv-carry row r holds global frame offset-kc+r; a negative
            # index stands in for the conv's zero left padding
            carry_mask = ((offset - kc + torch.arange(kc, device=dev)) >= 0).to(x.dtype)[None]
            for layer, st in zip(self.layers, tails):
                new_tail = torch.cat([st["tail"], x], dim=1)[:, -w:]
                x, new_conv = layer.chunk_step(x, st["tail"], st["conv"], bias, carry_mask)
                new_tails.append({"tail": new_tail, "conv": new_conv})
            return x, new_tails
        for layer, tail in zip(self.layers, tails):
            new_tails.append(torch.cat([tail, x], dim=1)[:, -w:])
            x = layer.chunk_step(x, tail, bias)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, new_tails


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        _, (alpha, _) = deepnorm_coeffs(cfg)
        dt = compute_dtype_of(cfg)
        self.self_attn = _attention(cfg)
        self.cross_attn = _attention(cfg)
        self.ffn = _ffn(cfg)
        self.sub1 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha, dtype=dt)
        self.sub2 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha, dtype=dt)
        self.sub3 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha, dtype=dt)

    def forward(
        self, x, enc_out, self_bias, cross_bias, ys_lengths=None, enc_lengths=None,
        rng=None,
    ):
        fused = (
            self.cfg.get("decoder_attn_impl", "xla") == "fused"
            and ys_lengths is not None and enc_lengths is not None
        )
        if fused:  # causal self-attention + rectangular cross-attention kernels
            x = self.sub1(x, lambda y: self.self_attn.fused_causal(y, ys_lengths, rng))
            x = self.sub2(
                x,
                lambda y: self.cross_attn.fused_cross(
                    y, enc_out, ys_lengths, enc_lengths, rng
                ),
            )
        else:
            x = self.sub1(x, lambda y: self.self_attn(y, y, self_bias, rng))
            x = self.sub2(x, lambda y: self.cross_attn(y, enc_out, cross_bias, rng))
        return self.sub3(x, lambda y: self.ffn(y, rng))

    def step(self, x, self_cache, cross_cache, index, self_bias, cross_bias):
        """Cached single-token decode step. x: (B, 1, D)."""
        x, new_self = self.sub1(
            x,
            lambda y: self.self_attn.step_self(y, self_cache, index, self_bias),
            has_aux=True,
        )
        x = self.sub2(x, lambda y: self.cross_attn.step_cross(y, cross_cache, cross_bias))
        return self.sub3(x, self.ffn), new_self

    def step_lazy(self, x, self_cache, cross_cache, index, anc, self_bias, cross_bias):
        """``step`` with lazy beam reorder (see ``step_self_lazy``)."""
        x, new_self = self.sub1(
            x,
            lambda y: self.self_attn.step_self_lazy(
                y, self_cache, index, anc, self_bias
            ),
            has_aux=True,
        )
        x = self.sub2(x, lambda y: self.cross_attn.step_cross(y, cross_cache, cross_bias))
        return self.sub3(x, self.ffn), new_self

    def make_cross_cache(self, enc_out):
        k, v = self.cross_attn.kv(enc_out)
        return {"k": k, "v": v}


class Decoder(nn.Module):
    def __init__(self, cfg: Config, vocab_size: int):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype_of(cfg)
        self.embed = Embedding(vocab_size, cfg.d_model, dt)
        self.pe = PositionalEncoding(cfg.d_model)
        self.dropout = ConfigurableDropout(cfg.dropout_rate, cfg.get("dropout_impl", "rng"))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers)
        )
        self.final_norm = LayerNorm(cfg.d_model, dt) if cfg.norm_type == "pre" else None

    def _embed_scaled(self, ys):
        # the JAX package scales by a float32 numpy scalar, which promotes a
        # bf16 embedding to f32
        return self.embed(ys).float() * float(np.float32(np.sqrt(self.cfg.d_model)))

    def _project(self, x):
        # tied output projection (transformer_official.py:253-258)
        return self.embed.attend(x).float()

    def forward(self, ys_in, ys_in_lengths, enc_out, enc_lengths, rng=None):
        t = ys_in.shape[1]
        x = self.dropout(self.pe(self._embed_scaled(ys_in)), rng)
        self_bias = causal_padding_bias(ys_in_lengths, t)
        cross_bias = padding_bias(enc_lengths, enc_out.shape[1])
        remat = self.cfg.get("remat", False)
        for layer in self.layers:
            x = run_layer(
                layer, remat, rng, x, enc_out, self_bias, cross_bias, ys_in_lengths,
                enc_lengths,
            )
        if self.final_norm is not None:
            x = self.final_norm(x)
        return self._project(x)

    # -- cached autoregressive decoding -------------------------------------
    def init_state(self, enc_out, enc_lengths, batch: int, max_len: int):
        """{"carry": per-hypothesis self-attention caches (what a beam
        reorder gathers), "static": beam-invariant cross k/v and bias}.
        ``batch`` may be B*beam."""
        dtype, dev = enc_out.dtype, enc_out.device
        self_caches = [
            l.self_attn.make_cache(batch, max_len, dtype, dev) for l in self.layers
        ]
        cross_caches = [l.make_cross_cache(enc_out) for l in self.layers]
        cross_bias = padding_bias(enc_lengths, enc_out.shape[1])
        return {
            "carry": {"self": self_caches},
            "static": {"cross": cross_caches, "cross_bias": cross_bias},
        }

    def _step_input(self, tokens, index, state):
        x = self._embed_scaled(tokens[:, None])
        x = x + pe_table(self.cfg.d_model, x.device)[index][None, None].to(x.dtype)
        max_len = state["carry"]["self"][0]["k"].shape[2]
        pos = torch.arange(max_len, device=x.device)[None, None, None, :]
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        self_bias = torch.where(pos <= index, zero, NEG_INF)
        return x, self_bias

    def _step_output(self, x, new_self, state):
        if self.final_norm is not None:
            x = self.final_norm(x)
        logits = self._project(x)[:, 0]
        new_state = {"carry": {"self": new_self}, "static": state["static"]}
        return torch.log_softmax(logits, dim=-1), new_state

    def step(self, tokens, state, index: int):
        """One decode step. tokens: (B,) token at position ``index``.
        Returns (log-probs (B, V) float32, new state)."""
        x, self_bias = self._step_input(tokens, index, state)
        cross_bias = state["static"]["cross_bias"]
        new_self = []
        for layer, sc, cc in zip(
            self.layers, state["carry"]["self"], state["static"]["cross"]
        ):
            x, nsc = layer.step(x, sc, cc, index, self_bias, cross_bias)
            new_self.append(nsc)
        return self._step_output(x, new_self, state)

    def step_lazy(self, tokens, state, index: int, anc):
        """One decode step with lazy beam reorder; anc: (B, K, Lmax)."""
        x, self_bias = self._step_input(tokens, index, state)
        cross_bias = state["static"]["cross_bias"]
        new_self = []
        for layer, sc, cc in zip(
            self.layers, state["carry"]["self"], state["static"]["cross"]
        ):
            x, nsc = layer.step_lazy(x, sc, cc, index, anc, self_bias, cross_bias)
            new_self.append(nsc)
        return self._step_output(x, new_self, state)


def preprocess_targets(labels: torch.Tensor, label_lengths: torch.Tensor):
    """labels (B, L) PAD-padded -> (ys_in (B, L+1), ys_out (B, L+1)):
    ys_in = [sos, labels...], ys_out = [labels..., eos], PAD elsewhere
    (``Decoder.preprocess``, ``transformer_official.py:260-275``)."""
    b, l = labels.shape
    dev = labels.device
    bos = torch.full((b, 1), BOS_ID, dtype=labels.dtype, device=dev)
    ys_in = torch.cat([bos, labels], dim=1)
    pad_col = torch.full((b, 1), PAD_ID, dtype=labels.dtype, device=dev)
    base = torch.cat([labels, pad_col], dim=1)
    eos_at = torch.arange(l + 1, device=dev)[None, :] == label_lengths.to(dev)[:, None]
    return ys_in, base + EOS_ID * eos_at.to(labels.dtype)


class SpeechTransformer(nn.Module):
    """Hybrid CTC/attention Speech-Transformer (flagship model).

    ``generator`` seeds the weight init (default: seed 0); the weights are
    made in float32 on the CPU. Each layer computes in the configured dtype
    (``compute_dtype``) from float32 weights, so the model trains in bf16
    with f32 master weights as it is; the serving path may also cast the
    weights with ``.to(device, dtype)``."""

    # beam search may keep cross K/V at one row per utterance and fold the
    # beam dim into queries (see MultiHeadAttention.step_cross)
    FOLD_BEAM_CROSS = True

    @staticmethod
    def input_dim_from_features(cfg: Config) -> bool:
        """Whether the input width is the features' whatever ``input_dim``
        says: flax infers it from the data for the conv2d frontend only."""
        return cfg.get("frontend", "linear") == "conv2d"

    def __init__(self, cfg: Config, vocab_size: int, generator=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.vocab_size = vocab_size
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg, vocab_size)
            self.ctc_head = (
                Dense(cfg.d_model, vocab_size, compute_dtype_of(cfg))
                if cfg.ctc_weight > 0.0 else None
            )
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype_of(self.cfg)

    def forward(self, feats, feat_lengths, labels, label_lengths, rng=None):
        """Teacher-forced forward (``rng``: a dropout generator for training,
        None for evaluation). Returns {"logits" (B, L+1, V) f32, "gold"
        (B, L+1), "enc_out", "enc_lengths"} and, with a CTC head,
        "ctc_logits" (B, T, V) in the compute dtype (the CTC loss upcasts
        inside)."""
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, rng)
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        logits = self.decoder(ys_in, label_lengths + 1, enc_out, enc_lengths, rng)
        out = {
            "logits": logits,
            "gold": ys_out,
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }
        if self.ctc_head is not None:
            out["ctc_logits"] = self.ctc_head(enc_out)
        return out

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    # -- streaming entry points (see stream.py) -----------------------------
    def init_chunk_tails(self, batch: int):
        return self.encoder.init_chunk_tails(batch)

    def encode_chunk(self, feats_chunk, tails, offset: int):
        """Incremental encode of F new frames: (enc (B, F, d), new_tails,
        CTC log-probs (B, F, V) in f32, or None without a CTC head)."""
        enc, new_tails = self.encoder.encode_chunk(feats_chunk, tails, offset)
        lp = None
        if self.ctc_head is not None:
            lp = torch.log_softmax(self.ctc_head(enc).float(), dim=-1)
        return enc, new_tails, lp

    def decode_logits(self, ys_in, ys_in_lengths, enc_out, enc_lengths):
        """Uncached full-prefix decoder forward (rescoring and the oracle
        for the cached path)."""
        return self.decoder(ys_in, ys_in_lengths, enc_out, enc_lengths)

    def init_decode_state(self, enc_out, enc_lengths, max_len: int, beam: int = 1):
        """Decode state for ``enc_out.shape[0] * beam`` hypothesis rows;
        cross K/V stay at one row per utterance."""
        return self.decoder.init_state(
            enc_out, enc_lengths, enc_out.shape[0] * beam, max_len
        )

    def decode_step(self, tokens, state, index: int):
        return self.decoder.step(tokens, state, index)

    def decode_step_lazy(self, tokens, state, index: int, anc):
        return self.decoder.step_lazy(tokens, state, index, anc)

    def ctc_log_probs(self, enc_out):
        if self.ctc_head is None:
            raise ValueError("model has no CTC head (ctc_weight == 0)")
        return torch.log_softmax(self.ctc_head(enc_out).float(), dim=-1)


@torch.no_grad()
def init_weights(model: SpeechTransformer, generator: torch.Generator) -> None:
    """Initialise every parameter from ``generator``, following the JAX
    package's initialisers: lecun-normal Dense kernels and zero biases;
    xavier-normal times DeepNorm's beta on the value/output projections
    and the FFNs when ``deepnorm`` is on (not in a conformer block, whose
    JAX counterpart takes no DeepNorm init); lecun-normal convolution
    kernels (fan-in: the kernel's taps times its input channels per
    group) and zero biases; normal(1/sqrt(d)) embeddings; unit LayerNorm
    scales."""
    (_, enc_beta), (_, dec_beta) = deepnorm_coeffs(model.cfg)
    if is_conformer(model.cfg):
        enc_beta = 1.0

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    def lecun_(lin):
        normal_(lin.weight, 1.0 / np.sqrt(lin.in_features))
        lin.bias.zero_()

    def xavier_(lin, beta):
        if beta == 1.0:
            return lecun_(lin)
        std = np.sqrt(2.0 / (lin.in_features + lin.out_features)) * beta
        normal_(lin.weight, std)
        lin.bias.zero_()

    for mod in model.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            normal_(mod.weight, 1.0 / np.sqrt(mod.weight[0].numel()))
            mod.bias.zero_()
        elif isinstance(mod, ConvModule):
            lecun_(mod.pw1)
            lecun_(mod.pw2)
    for stack, beta in ((model.encoder, enc_beta), (model.decoder, dec_beta)):
        for mha in (m for m in stack.modules() if isinstance(m, MultiHeadAttention)):
            lecun_(mha.q_proj)
            lecun_(mha.k_proj)
            xavier_(mha.v_proj, beta)
            xavier_(mha.out_proj, beta)
        for ffn in (m for m in stack.modules() if isinstance(m, PositionwiseFFN)):
            xavier_(ffn.w1, beta)
            xavier_(ffn.w2, beta)
    if hasattr(model.encoder, "frontend_mod"):
        lecun_(model.encoder.frontend_mod.proj)
    else:
        lecun_(model.encoder.input_proj)
    normal_(model.decoder.embed.weight, 1.0 / np.sqrt(model.cfg.d_model))
    if model.ctc_head is not None:
        lecun_(model.ctc_head)
