"""Plain float32 reference of ESPnet's AISHELL-1 conformer
(``egs2/aishell/asr1/conf/tuning/train_asr_conformer.yaml``) with the
port's pre-LN transformer decoder, for the CPU tests of the port's rel-pos
conformer (``tests/test_torch_espnet_conformer.py``). It imports no kernel
of the port and no JAX; it reads a state dict named as the port's
``SpeechTransformer`` names it and follows ESPnet's equations:

- ``Conv2dSubsampling``: Conv2d(1 -> c, 3, stride 2), ReLU, Conv2d(c -> c,
  3, stride 2), ReLU, valid padding; the (f, c) features of a frame
  (channel fastest, the port's order) projected to d; lengths (l - 1) // 2
  twice;
- ``RelPositionalEncoding`` (``latest``): x sqrt(d); the (2T - 1, d) table
  whose row r is the sinusoid of relative position T - 1 - r;
- per block: x + FFN/2, x + rel-pos MHSA, x + conv module, x + FFN/2, each
  on its LayerNorm, then the block's LayerNorm; ``after_norm`` at the end;
- ``RelPositionMultiHeadedAttention``: (q + u) k^T + rel_shift((q + v)
  p^T), over sqrt(d_k), masked keys at the float32 minimum and their
  weights zeroed, ``rel_shift`` the pad-view-slice copy ESPnet writes;
- the conv module: pointwise d -> 2d, GLU, padded frames zeroed (WeNet),
  depthwise SAME, LayerNorm, swish, pointwise;
- swish FFNs in the encoder, ReLU in the decoder.

No dropout: the tests compare deterministic forwards and gradients. Set
``allow_tf32`` off (``no_tf32``) before a card run."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
NEG = -1e9
BOS, EOS = 2, 3


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """ESPnet's ``rel_shift``: (B, H, T, 2T - 1) -> (B, H, T, T) with [i, j]
    <- [i, T - 1 - i + j]."""
    zero_pad = torch.zeros((*x.size()[:3], 1), device=x.device, dtype=x.dtype)
    x_padded = torch.cat([zero_pad, x], dim=-1)
    x_padded = x_padded.view(*x.size()[:2], x.size(3) + 1, x.size(2))
    return x_padded[:, :, 1:].view_as(x)[:, :, :, : x.size(-1) // 2 + 1]


def sinusoids(positions: np.ndarray, d: int) -> torch.Tensor:
    """(len(positions), d): sin on even dims, cos on odd, 10000^(-2m/d), in
    float64 -> float32."""
    m = np.arange(d)[None, :] // 2
    angle = positions.astype(np.float64)[:, None] * np.power(10000.0, -2.0 * m / d)
    table = np.where(np.arange(d)[None, :] % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


class PlainConformer:
    """``cfg``: the model keys (d_model, num_heads, head_dim,
    num_encoder_layers, num_decoder_layers, ctc_weight, label_smoothing);
    ``w``: {name: float32 tensor}."""

    def __init__(self, cfg: dict, w: dict):
        self.cfg, self.w = cfg, w
        self.d, self.h, self.dk = cfg["d_model"], cfg["num_heads"], cfg["head_dim"]

    def dense(self, x, name, bias=True):
        return F.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"] if bias else None)

    def norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            LN_EPS)

    # -- the encoder -----------------------------------------------------------

    def subsample(self, feats, lengths):
        y = feats[:, None]
        for conv in ("conv0", "conv1"):
            n = f"encoder.frontend_mod.{conv}"
            y = torch.relu(F.conv2d(y, self.w[f"{n}.weight"], self.w[f"{n}.bias"], stride=2))
        b, c, t, f = y.shape
        y = self.dense(y.permute(0, 2, 3, 1).reshape(b, t, f * c), "encoder.frontend_mod.proj")
        return y, ((lengths - 1) // 2 - 1) // 2

    def ffn(self, x, name, act):
        return self.dense(act(self.dense(x, f"{name}.w1")), f"{name}.w2")

    def rel_attention(self, x, name, table, keys):
        b, t, _ = x.shape
        heads = lambda y: y.reshape(b, -1, self.h, self.dk).transpose(1, 2)
        q = self.dense(x, f"{name}.q_proj").reshape(b, t, self.h, self.dk)
        k, v = heads(self.dense(x, f"{name}.k_proj")), heads(self.dense(x, f"{name}.v_proj"))
        p = self.dense(table, f"{name}.linear_pos", bias=False)
        p = p.reshape(1, -1, self.h, self.dk).transpose(1, 2)  # shared by the batch
        qu = (q + self.w[f"{name}.pos_bias_u"]).transpose(1, 2)
        qv = (q + self.w[f"{name}.pos_bias_v"]).transpose(1, 2)
        ac = torch.matmul(qu, k.transpose(-2, -1))
        bd = rel_shift(torch.matmul(qv, p.transpose(-2, -1)))
        scores = (ac + bd) / math.sqrt(self.dk)
        masked = ~keys[:, None, None, :]
        scores = scores.masked_fill(masked, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores, dim=-1).masked_fill(masked, 0.0)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, -1)
        return self.dense(out, f"{name}.out_proj")

    def conv_module(self, x, name, keys):
        y = F.glu(self.dense(x, f"{name}.pw1"), dim=-1) * keys[:, :, None].float()
        wd = self.w[f"{name}.dw.weight"]
        k = wd.shape[-1]
        y = F.conv1d(y.transpose(1, 2), wd, self.w[f"{name}.dw.bias"], padding=(k - 1) // 2,
                     groups=self.d).transpose(1, 2)
        return self.dense(F.silu(self.norm(y, f"{name}.norm")), f"{name}.pw2")

    def encode(self, feats, lengths):
        x, lengths = self.subsample(feats, lengths)
        t = x.shape[1]
        x = x * math.sqrt(self.d)
        table = sinusoids(np.arange(t - 1, -t, -1), self.d).to(x.device)
        keys = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        for i in range(self.cfg["num_encoder_layers"]):
            p = f"encoder.layers.{i}"
            x = x + 0.5 * self.ffn(self.norm(x, f"{p}.ln_ffn1"), f"{p}.ffn1", F.silu)
            x = x + self.rel_attention(self.norm(x, f"{p}.ln_attn"), f"{p}.attn", table, keys)
            x = x + self.conv_module(self.norm(x, f"{p}.ln_conv"), f"{p}.conv", keys)
            x = x + 0.5 * self.ffn(self.norm(x, f"{p}.ln_ffn2"), f"{p}.ffn2", F.silu)
            x = self.norm(x, f"{p}.ln_final")
        return self.norm(x, "encoder.final_norm"), lengths

    # -- the decoder (the port's pre-LN transformer decoder) ------------------

    def attention(self, xq, xkv, name, allow):
        b, tq, _ = xq.shape
        heads = lambda y: y.reshape(b, -1, self.h, self.dk).transpose(1, 2)
        q = heads(self.dense(xq, f"{name}.q_proj"))
        k, v = heads(self.dense(xkv, f"{name}.k_proj")), heads(self.dense(xkv, f"{name}.v_proj"))
        s = torch.matmul(q, k.transpose(-2, -1)) / math.sqrt(self.dk)
        wts = torch.softmax(s + torch.where(allow, 0.0, NEG), dim=-1)
        return self.dense(torch.matmul(wts, v).transpose(1, 2).reshape(b, tq, -1),
                          f"{name}.out_proj")

    def decode(self, ys_in, ys_lengths, enc, enc_lengths):
        b, t = ys_in.shape
        dev = ys_in.device
        emb = self.w["decoder.embed.weight"]
        x = emb[ys_in] * float(np.float32(np.sqrt(self.d)))
        x = x + sinusoids(np.arange(t), self.d).to(dev)
        pos = torch.arange(t, device=dev)
        self_allow = ((pos[None, :] <= pos[:, None])[None]
                      & (pos[None, None, :] < ys_lengths[:, None, None]))[:, None]
        cross_allow = (torch.arange(enc.shape[1], device=dev)[None, :]
                       < enc_lengths[:, None])[:, None, None]
        for i in range(self.cfg["num_decoder_layers"]):
            p = f"decoder.layers.{i}"
            y = self.norm(x, f"{p}.sub1.norm")
            x = x + self.attention(y, y, f"{p}.self_attn", self_allow)
            x = x + self.attention(self.norm(x, f"{p}.sub2.norm"), enc, f"{p}.cross_attn",
                                   cross_allow)
            x = x + self.ffn(self.norm(x, f"{p}.sub3.norm"), f"{p}.ffn", torch.relu)
        return F.linear(self.norm(x, "decoder.final_norm"), emb)

    # -- the loss ---------------------------------------------------------------

    def loss(self, feats, lengths, labels, label_lengths):
        """(ctc_weight x mean CTC NLL + (1 - ctc_weight) x label-smoothed CE
        over the batch's non-PAD targets, each utterance's loss)."""
        enc, enc_len = self.encode(feats, lengths)
        b, l = labels.shape
        dev = labels.device
        ys_in = torch.cat([torch.full((b, 1), BOS, dtype=labels.dtype, device=dev), labels], 1)
        gold = torch.cat([labels, torch.zeros((b, 1), dtype=labels.dtype, device=dev)], 1)
        gold = torch.where(torch.arange(l + 1, device=dev)[None, :] == label_lengths[:, None],
                           torch.full_like(gold, EOS), gold)
        logits = self.decode(ys_in, label_lengths + 1, enc, enc_len)
        eps, v = float(self.cfg.get("label_smoothing", 0.0)), logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1)
        q = torch.full_like(logp, eps / v).scatter(-1, gold[..., None], 1.0 - eps)
        mask = (gold != 0).float()
        per_pos = -(q * logp).sum(-1) * mask
        ce = per_pos.sum() / mask.sum()
        ce_rows = per_pos.sum(1) / mask.sum(1)
        w_ctc = float(self.cfg["ctc_weight"])
        ctc_lp = torch.log_softmax(self.dense(enc, "ctc_head"), dim=-1).transpose(0, 1)
        nll = F.ctc_loss(ctc_lp, labels.long(), enc_len.long(), label_lengths.long(), blank=0,
                         reduction="none")
        return w_ctc * nll.mean() + (1 - w_ctc) * ce, w_ctc * nll + (1 - w_ctc) * ce_rows
