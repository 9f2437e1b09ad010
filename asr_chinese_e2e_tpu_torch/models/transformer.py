"""Speech-Transformer encoder/decoder with optional CTC head, in torch.

Counterpart of ``asr_chinese_e2e_tpu/models/transformer.py`` for the
serving path: encode, the uncached and KV-cached decoder, and the CTC
head. The teacher-forced training forward, the conformer encoder, the
conv2d frontend, streaming chunk encoding and the flash / ring / fused
decoder attention paths are not ported yet; asking for them raises
``NotImplementedError`` naming the ROADMAP item.

Weights are created from an explicit ``torch.Generator`` (the JAX
package draws them from a PRNG key), or converted from flax with
``models/convert.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.config import Config
from ..ops.masks import (
    NEG_INF,
    banded_bias,
    causal_banded_bias,
    causal_bias,
    causal_padding_bias,
    padding_bias,
)
from .layers import (
    LN_EPS,
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
    unsupported = [
        (cfg.get("attn_impl", "xla") == "flash",
         "attn_impl='flash' (ROADMAP §1, item 1: training, with K2)"),
        (cfg.get("attn_impl", "xla") == "ring",
         "attn_impl='ring' (ROADMAP §1, item 7: parallelism)"),
        (cfg.get("frontend", "linear") == "conv2d",
         "frontend='conv2d' (ROADMAP §1, item 4: conformer and conv2d frontend)"),
        (cfg.get("encoder_type", "transformer") == "conformer",
         "encoder_type='conformer' (ROADMAP §1, item 4: conformer and conv2d "
         "frontend)"),
        (cfg.get("decoder_attn_impl", "xla") == "fused",
         "decoder_attn_impl='fused' (ROADMAP §1, item 1: training, with K2)"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")
    if cfg.get("attn_impl", "xla") not in ("xla", "fused"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _encoder_self_attention(cfg, attn, x, bias, lengths):
    """Encoder self-attention dispatch on ``attn_impl``: "fused" runs the
    attention kernel (band / causal patterns in the kernel), "xla" the
    plain masked products."""
    impl = cfg.get("attn_impl", "xla")
    band = cfg.get("attention_band", 0)
    causal = cfg.get("causal_encoder", False)
    if impl == "fused" and lengths is not None:
        if band or causal:
            return attn.fused_pattern(x, lengths, causal, band)
        return attn.fused(x, lengths)
    return attn(x, x, bias)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        (alpha, _), _ = deepnorm_coeffs(cfg)
        self.attn = MultiHeadAttention(cfg.num_heads, cfg.d_model, cfg.head_dim)
        self.ffn = PositionwiseFFN(cfg.d_model, cfg.d_ff)
        self.sub1 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha)
        self.sub2 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha)

    def forward(self, x, bias, lengths=None):
        x = self.sub1(
            x, lambda y: _encoder_self_attention(self.cfg, self.attn, y, bias, lengths)
        )
        return self.sub2(x, self.ffn)


class Encoder(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.input_proj = nn.Linear(cfg.input_dim, cfg.d_model)
        self.input_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.pe = PositionalEncoding(cfg.d_model)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.num_encoder_layers)
        )
        self.final_norm = (
            nn.LayerNorm(cfg.d_model, eps=LN_EPS) if cfg.norm_type == "pre" else None
        )

    def forward(self, feats, feat_lengths):
        c = self.cfg
        x = self.input_norm(self.input_proj(feats.to(self.input_proj.weight.dtype)))
        x = self.pe(x)
        t, dev = x.shape[1], x.device
        bias = padding_bias(feat_lengths, t)
        band = c.get("attention_band", 0)
        if c.get("causal_encoder", False):
            bias = bias + (
                causal_banded_bias(t, band, dev) if band else causal_bias(t, dev)
            )
        elif band:
            bias = bias + banded_bias(t, band, dev)
        for layer in self.layers:
            x = layer(x, bias, feat_lengths)
        if self.final_norm is not None:
            x = self.final_norm(x)
        return x, feat_lengths


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        _, (alpha, _) = deepnorm_coeffs(cfg)
        self.self_attn = MultiHeadAttention(cfg.num_heads, cfg.d_model, cfg.head_dim)
        self.cross_attn = MultiHeadAttention(cfg.num_heads, cfg.d_model, cfg.head_dim)
        self.ffn = PositionwiseFFN(cfg.d_model, cfg.d_ff)
        self.sub1 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha)
        self.sub2 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha)
        self.sub3 = SubLayer(cfg.norm_type, cfg.d_model, alpha=alpha)

    def forward(self, x, enc_out, self_bias, cross_bias):
        x = self.sub1(x, lambda y: self.self_attn(y, y, self_bias))
        x = self.sub2(x, lambda y: self.cross_attn(y, enc_out, cross_bias))
        return self.sub3(x, self.ffn)

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
        self.embed = nn.Embedding(vocab_size, cfg.d_model)
        self.pe = PositionalEncoding(cfg.d_model)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg) for _ in range(cfg.num_decoder_layers)
        )
        self.final_norm = (
            nn.LayerNorm(cfg.d_model, eps=LN_EPS) if cfg.norm_type == "pre" else None
        )

    def _embed_scaled(self, ys):
        return self.embed(ys) * float(np.float32(np.sqrt(self.cfg.d_model)))

    def _project(self, x):
        # tied output projection (transformer_official.py:253-258)
        w = self.embed.weight
        return (x.to(w.dtype) @ w.t()).float()

    def forward(self, ys_in, ys_in_lengths, enc_out, enc_lengths):
        t = ys_in.shape[1]
        x = self.pe(self._embed_scaled(ys_in))
        self_bias = causal_padding_bias(ys_in_lengths, t)
        cross_bias = padding_bias(enc_lengths, enc_out.shape[1])
        for layer in self.layers:
            x = layer(x, enc_out, self_bias, cross_bias)
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


class SpeechTransformer(nn.Module):
    """Hybrid CTC/attention Speech-Transformer (flagship model).

    ``generator`` seeds the weight init (default: seed 0); the weights are
    made in float32 on the CPU. Move the model with ``.to(device, dtype)``
    (``compute_dtype`` gives the configured dtype)."""

    # beam search may keep cross K/V at one row per utterance and fold the
    # beam dim into queries (see MultiHeadAttention.step_cross)
    FOLD_BEAM_CROSS = True

    def __init__(self, cfg: Config, vocab_size: int, generator=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.vocab_size = vocab_size
        with torch.device("meta"):
            self.encoder = Encoder(cfg)
            self.decoder = Decoder(cfg, vocab_size)
            self.ctc_head = (
                nn.Linear(cfg.d_model, vocab_size) if cfg.ctc_weight > 0.0 else None
            )
        self.to_empty(device="cpu")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.get("dtype") == "bfloat16" else torch.float32

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

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
    and the FFNs when ``deepnorm`` is on; normal(1/sqrt(d)) embeddings;
    unit LayerNorm scales."""
    (_, enc_beta), (_, dec_beta) = deepnorm_coeffs(model.cfg)

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
    for stack, beta in ((model.encoder, enc_beta), (model.decoder, dec_beta)):
        for mha in (m for m in stack.modules() if isinstance(m, MultiHeadAttention)):
            lecun_(mha.q_proj)
            lecun_(mha.k_proj)
            xavier_(mha.v_proj, beta)
            xavier_(mha.out_proj, beta)
        for ffn in (m for m in stack.modules() if isinstance(m, PositionwiseFFN)):
            xavier_(ffn.w1, beta)
            xavier_(ffn.w2, beta)
    lecun_(model.encoder.input_proj)
    normal_(model.decoder.embed.weight, 1.0 / np.sqrt(model.cfg.d_model))
    if model.ctc_head is not None:
        lecun_(model.ctc_head)
