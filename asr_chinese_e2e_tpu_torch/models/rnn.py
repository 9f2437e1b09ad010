"""RNN model family in torch: a BiLSTM encoder with a CTC head
(``BiLSTMCTC``) and the BiLSTM encoder-decoder with location-aware
attention and joint CTC/CE (``LAS``).

Counterpart of ``asr_chinese_e2e_tpu/models/rnn.py``. The JAX package runs
each recurrence as a ``lax.scan`` under flax ``nn.RNN`` (no Pallas kernel);
here the encoder's recurrences are ``nn.LSTM`` (cuDNN on the card) and the
decoder's is ``nn.LSTMCell``, one call a target position.

- flax's backward direction (``reverse=True, keep_order=True`` with
  ``seq_lengths``) reverses each sequence within its own length and its
  padding among itself; ``flip_index`` builds that permutation once per
  batch as a device gather, so no length goes to the host. Both directions
  run over the full padded T: no padded frame reaches a valid output, and
  the encoder's final mask zeroes the padded rows.
- The LSTMs compute in float32 whatever ``cfg.dtype``: flax's
  ``OptimizedLSTMCell`` takes no dtype and promotes its input to its f32
  kernels. The dense layers, the embedding and the location conv compute
  in the model dtype, as flax's ``dtype=`` does. cuDNN runs the encoder's
  LSTMs and the location conv without TF32 (``layers.keep_cudnn_f32``).
- flax's LSTM cell has one bias (on its hidden kernels) where torch's has
  two: torch's input bias ``bias_ih`` stays zero and takes no gradient
  (``_one_bias``), so the optimizer updates the cell as optax does.
- Dropout is ``ConfigurableDropout("rng")`` (flax ``nn.Dropout``): after
  each encoder layer and on the decoder's embeddings.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import Config
from ..ops.masks import NEG_INF, length_mask
from .layers import ConfigurableDropout, Dense, Embedding, keep_cudnn_f32, same_padding
from .transformer import compute_dtype_of, preprocess_targets


def default_ctc_config() -> Config:
    """North-star config #1: tiny BiLSTM + CTC."""
    return Config(
        hidden_size=128,
        num_encoder_layers=2,
        dropout_rate=0.1,
        input_dim=320,
        ctc_weight=1.0,
        label_smoothing=0.0,
        max_target_len=128,
        dtype="float32",
    )


def default_las_config() -> Config:
    """North-star config #2: BiLSTM enc-dec, location-aware attention,
    joint CTC/CE."""
    cfg = default_ctc_config()
    cfg.build(
        num_encoder_layers=3,
        hidden_size=256,
        embed_dim=256,
        attention_dim=256,
        location_filters=10,
        location_kernel=31,
        num_decoder_layers=1,
        ctc_weight=0.3,
    )
    return cfg


def flip_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B, T) gather index of flax's ``flip_sequences``: row b reads
    ``(T - 1 - t + len_b) mod T``, which reverses [0, len_b) and the padding
    [len_b, T) each in place. The permutation is its own inverse."""
    rev = torch.arange(t - 1, -1, -1, device=lengths.device)
    return (rev[None, :] + lengths.to(torch.int64)[:, None]) % t


def _one_bias(cell: nn.Module) -> nn.Module:
    """Freeze the input bias of an ``nn.LSTM`` / ``nn.LSTMCell`` (zeroed
    by ``init_weights`` and the converter): flax's cell has the hidden
    bias only."""
    for name, p in cell.named_parameters():
        if name.startswith("bias_ih"):
            p.requires_grad_(False)
    return cell


def _flip(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return x.gather(1, index[..., None].expand(-1, -1, x.shape[-1]))


class BiLSTMEncoder(nn.Module):
    """Stacked bidirectional LSTM; layer i's output is [forward, backward]
    (2 * hidden wide), then dropout; the output is masked by length."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype_of(cfg)
        h = cfg.hidden_size
        widths = [cfg.input_dim] + [2 * h] * (cfg.num_encoder_layers - 1)
        self.fwd = nn.ModuleList(_one_bias(nn.LSTM(w, h, batch_first=True)) for w in widths)
        self.bwd = nn.ModuleList(_one_bias(nn.LSTM(w, h, batch_first=True)) for w in widths)
        self.dropout = ConfigurableDropout(cfg.dropout_rate, "rng")

    def forward(self, feats, feat_lengths, rng=None):
        keep_cudnn_f32(feats)
        x = feats.to(self.compute_dtype).float()
        index = flip_index(feat_lengths, x.shape[1])
        for fwd, bwd in zip(self.fwd, self.bwd):
            y_fwd, _ = fwd(x)
            y_bwd, _ = bwd(_flip(x, index))
            x = self.dropout(torch.cat([y_fwd, _flip(y_bwd, index)], dim=-1), rng)
        mask = length_mask(feat_lengths, x.shape[1]).to(x.dtype)
        return x * mask[..., None], feat_lengths


class LocationAwareAttention(nn.Module):
    """Additive attention with convolutional location features (Chorowski
    et al. 2015): score(s, h_j) = w·tanh(W s + V h_j + U f_j + b), f =
    conv1d(previous alignment). Masked frames get NEG_INF before the f32
    softmax."""

    def __init__(self, cfg: Config, query_dim: int, enc_dim: int):
        super().__init__()
        a, dt = cfg.attention_dim, compute_dtype_of(cfg)
        self.compute_dtype = dt
        self.query_proj = Dense(query_dim, a, dt)
        self.location_conv = nn.Conv1d(
            1, cfg.location_filters, cfg.location_kernel, bias=False
        )
        self.location_proj = Dense(cfg.location_filters, a, dt, bias=False)
        self.score_proj = Dense(a, 1, dt, bias=False)
        self.enc_proj_dense = Dense(enc_dim, a, dt, bias=False)

    def forward(self, query, enc_proj, enc_out, prev_align, enc_mask_bias):
        """query (B, D_dec); enc_proj (B, T, A) from ``project_encoder``;
        prev_align (B, T); enc_mask_bias (B, T) additive. Returns (context
        (B, D_enc), align (B, T) f32)."""
        dt = self.compute_dtype
        keep_cudnn_f32(query)
        q = self.query_proj(query)
        k = self.location_conv.kernel_size[0]
        f = F.conv1d(
            F.pad(prev_align.to(dt)[:, None], same_padding(prev_align.shape[1], k, 1)),
            self.location_conv.weight.to(dt),
        )
        f = self.location_proj(f.transpose(1, 2))
        e = self.score_proj(torch.tanh(q[:, None, :] + enc_proj + f))[..., 0]
        align = torch.softmax(e.float() + enc_mask_bias, dim=-1)
        context = torch.einsum("bt,btd->bd", align.to(dt).to(enc_out.dtype), enc_out)
        return context, align

    def project_encoder(self, enc_out):
        return self.enc_proj_dense(enc_out)


def _mask_bias(enc_lengths, t: int) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=enc_lengths.device)
    return torch.where(length_mask(enc_lengths, t), zero, NEG_INF)


class LASDecoder(nn.Module):
    """Unidirectional LSTM decoder with location-aware attention. The
    teacher-forced forward loops over target positions (the JAX package's
    ``nn.scan``) and projects every position's [s, context] in one GEMM
    after the loop; ``step`` is the cached single-token path of the
    searches. The LSTM carry is flax's (c, h) tuple."""

    def __init__(self, cfg: Config, vocab_size: int, enc_dim: int):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype_of(cfg)
        self.compute_dtype = dt
        self.embed = Embedding(vocab_size, cfg.embed_dim, dt)
        self.cell = _one_bias(nn.LSTMCell(cfg.embed_dim + enc_dim, cfg.hidden_size))
        self.attention = LocationAwareAttention(cfg, cfg.hidden_size, enc_dim)
        self.out_proj = Dense(cfg.hidden_size + enc_dim, vocab_size, dt)
        self.dropout = ConfigurableDropout(cfg.dropout_rate, "rng")

    def _init_carry(self, batch: int, enc_out):
        dev = enc_out.device
        zeros = torch.zeros((batch, self.cfg.hidden_size), device=dev)
        align = torch.zeros((batch, enc_out.shape[1]), device=dev)
        context = torch.zeros((batch, enc_out.shape[-1]), dtype=self.compute_dtype,
                              device=dev)
        return (zeros, zeros), align, context

    def _one_step(self, token_emb, carry, align, context, enc_proj, enc_out, bias):
        """One position: returns (carry, align, context, s)."""
        c, h = carry
        inp = torch.cat([token_emb, context.to(token_emb.dtype)], dim=-1)
        h, c = self.cell(inp.float(), (h, c))
        context, align = self.attention(h, enc_proj, enc_out, align, bias)
        return (c, h), align, context, h

    def _logits(self, s, context):
        dt = self.compute_dtype
        return self.out_proj(torch.cat([s.to(dt), context.to(dt)], dim=-1)).float()

    def forward(self, ys_in, enc_out, enc_lengths, rng=None):
        """Teacher-forced logits (B, L, V) f32."""
        b, l = ys_in.shape
        enc_proj = self.attention.project_encoder(enc_out)
        bias = _mask_bias(enc_lengths, enc_out.shape[1])
        emb = self.dropout(self.embed(ys_in), rng)
        carry, align, context = self._init_carry(b, enc_out)
        states, contexts = [], []
        for t in range(l):
            carry, align, context, s = self._one_step(
                emb[:, t], carry, align, context, enc_proj, enc_out, bias
            )
            states.append(s)
            contexts.append(context)
        return self._logits(torch.stack(states, 1), torch.stack(contexts, 1))

    # -- cached decode ------------------------------------------------------
    def init_state(self, enc_out, enc_lengths):
        """{"carry": per-hypothesis recurrent state (gathered on beam
        reorder), "static": beam-invariant encoder tensors (never
        gathered)}."""
        carry, align, context = self._init_carry(enc_out.shape[0], enc_out)
        return {
            "carry": {"cell": carry, "align": align, "context": context},
            "static": {
                "enc_proj": self.attention.project_encoder(enc_out),
                "enc_out": enc_out,
                "bias": _mask_bias(enc_lengths, enc_out.shape[1]),
            },
        }

    def step(self, tokens, state, index=None):
        """One decode step (the RNN state carries the position). Returns
        (log-probs (B, V) f32, new state)."""
        del index
        st, carry = state["static"], state["carry"]
        cell, align, context, s = self._one_step(
            self.embed(tokens), carry["cell"], carry["align"], carry["context"],
            st["enc_proj"], st["enc_out"], st["bias"],
        )
        new_state = {
            "carry": {"cell": cell, "align": align, "context": context},
            "static": st,
        }
        return torch.log_softmax(self._logits(s, context), dim=-1), new_state


class BiLSTMCTC(nn.Module):
    """North-star config #1: BiLSTM encoder + CTC head only. ``generator``
    seeds the weight init (default seed 0)."""

    @staticmethod
    def input_dim_from_features(cfg: Config) -> bool:
        """flax infers the first LSTM's input width from the data."""
        return True

    def __init__(self, cfg: Config, vocab_size: int, generator=None):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        self.encoder = BiLSTMEncoder(cfg)
        self.ctc_head = Dense(2 * cfg.hidden_size, vocab_size, compute_dtype_of(cfg))
        init_weights(self, generator)

    def forward(self, feats, feat_lengths, labels, label_lengths, rng=None):
        """{"ctc_logits" (B, T, V) in the model dtype (the CTC loss upcasts
        inside), "enc_out", "enc_lengths"}."""
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, rng)
        return {
            "ctc_logits": self.ctc_head(enc_out),
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def ctc_log_probs(self, enc_out):
        return torch.log_softmax(self.ctc_head(enc_out).float(), dim=-1)


class LAS(nn.Module):
    """North-star config #2: BiLSTM encoder + location-aware-attention
    decoder, joint CTC/CE (a CTC head when ``ctc_weight`` > 0). Beam and
    joint searches take the carry-gather route: no ``decode_step_lazy``."""

    input_dim_from_features = BiLSTMCTC.input_dim_from_features

    def __init__(self, cfg: Config, vocab_size: int, generator=None):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        enc_dim = 2 * cfg.hidden_size
        self.encoder = BiLSTMEncoder(cfg)
        self.decoder = LASDecoder(cfg, vocab_size, enc_dim)
        self.ctc_head = (
            Dense(enc_dim, vocab_size, compute_dtype_of(cfg))
            if cfg.ctc_weight > 0.0 else None
        )
        init_weights(self, generator)

    def forward(self, feats, feat_lengths, labels, label_lengths, rng=None):
        """{"logits" (B, L+1, V) f32, "gold" (B, L+1), "enc_out",
        "enc_lengths"} and, with a CTC head, "ctc_logits"."""
        enc_out, enc_lengths = self.encoder(feats, feat_lengths, rng)
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        out = {
            "logits": self.decoder(ys_in, enc_out, enc_lengths, rng),
            "gold": ys_out,
            "enc_out": enc_out,
            "enc_lengths": enc_lengths,
        }
        if self.ctc_head is not None:
            out["ctc_logits"] = self.ctc_head(enc_out)
        return out

    def encode(self, feats, feat_lengths):
        return self.encoder(feats, feat_lengths)

    def init_decode_state(self, enc_out, enc_lengths, max_len: int = 0):
        del max_len
        return self.decoder.init_state(enc_out, enc_lengths)

    def decode_step(self, tokens, state, index=None):
        return self.decoder.step(tokens, state, index)

    def ctc_log_probs(self, enc_out):
        if self.ctc_head is None:
            raise ValueError("model has no CTC head (ctc_weight == 0)")
        return torch.log_softmax(self.ctc_head(enc_out).float(), dim=-1)


def _orthogonal(n: int, generator: torch.Generator) -> torch.Tensor:
    """An (n, n) orthogonal matrix (QR of a normal draw, signs fixed)."""
    q, r = torch.linalg.qr(torch.randn((n, n), generator=generator, dtype=torch.float64))
    return (q * torch.sign(torch.diagonal(r))[None, :]).float()


@torch.no_grad()
def init_weights(model: nn.Module, generator=None) -> None:
    """Initialise from ``generator`` (default: seed 0) with flax's
    initialisers: lecun-normal Dense, conv and LSTM input kernels, an
    orthogonal recurrent kernel per gate, zero biases, normal(1/sqrt(d))
    embeddings."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def lecun_(w, fan_in):
        w.copy_(torch.randn(w.shape, generator=generator) / np.sqrt(fan_in))

    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            lecun_(mod.weight, mod.in_features)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Conv1d):
            lecun_(mod.weight, mod.weight[0].numel())
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(
                torch.randn(mod.weight.shape, generator=generator)
                / np.sqrt(mod.embedding_dim)
            )
        elif isinstance(mod, (nn.LSTM, nn.LSTMCell)):
            sfx = "_l0" if isinstance(mod, nn.LSTM) else ""
            w_ih = getattr(mod, "weight_ih" + sfx)
            lecun_(w_ih, w_ih.shape[1])
            w_hh = getattr(mod, "weight_hh" + sfx)
            h = mod.hidden_size
            for g in range(4):
                w_hh[g * h:(g + 1) * h] = _orthogonal(h, generator).t()
            getattr(mod, "bias_ih" + sfx).zero_()
            getattr(mod, "bias_hh" + sfx).zero_()
