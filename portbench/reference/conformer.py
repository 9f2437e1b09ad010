"""Plain ESPnet AISHELL-1 conformer (``train_asr_conformer.yaml``) in
float32 PyTorch, as functions of a weight dict named as
``weights_conformer.py`` makes it; the decoder and the CTC head are
``model.py``'s (the pre-LN transformer decoder), without attention-weight
dropout (ESPnet's ``*_attention_dropout_rate`` 0).

The encoder follows ESPnet's equations: ``Conv2dSubsampling`` (two valid
3x3 stride-2 convolutions with ReLU, the (f, c) features of a frame
projected to d; lengths (l - 1) // 2 twice), x sqrt(d) and the (2T - 1)-row
relative table of ``RelPositionalEncoding`` (row r: position T - 1 - r),
each dropped out, then per block x + FFN/2, x + rel-pos MHSA, x + conv
module, x + FFN/2 (each on its LayerNorm), the block's final LayerNorm, and
``after_norm``. The rel-pos MHSA is ESPnet's ``RelPositionMultiHeaded
Attention`` (``latest``): (q + u) k^T + rel_shift((q + v) p^T), ``rel_shift``
the pad-view-slice copy ESPnet writes, over sqrt(d_k), masked keys at the
float32 minimum, their weights zeroed after the softmax. The conv module:
pointwise d -> 2d, GLU, padded frames zeroed, depthwise width k SAME,
LayerNorm, swish, pointwise, dropout. FFNs: swish.

Dropout follows the recipe as ``model.py`` does (a 31-bit seed a site from
the step's CPU generator, in the forward's order: the encoder input, the
relative table, per block the FFN, attention, conv and FFN outputs, then
the decoder's), hashed at the element's flat index in the whole batch's
tensor: a block of rows [r0, r0 + n) adds r0 times the row's size to its
indices and replays the batch's seeds (``BatchDropout``), so the batch can
be run in row blocks that each see the masks of their rows."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .model import M32, NEG, _finalize, _threshold, mul32
from .model import Dropout, Model, layer_norm, targets
from .precision import Precision


def flat_keep_at(seed: int, shape, rate: float, offset: int, device) -> torch.Tensor:
    """float32 keep mask scaled by 1/(1-rate), hashed at flat index +
    ``offset``."""
    n = int(np.prod(shape))
    idx = mul32(torch.arange(offset, offset + n, dtype=torch.int64, device=device) & M32,
                0x9E3779B9)
    h = _finalize(idx ^ mul32(torch.tensor(seed & M32, device=device), 0xC2B2AE35))
    return ((h >= _threshold(rate)).float() / (1.0 - rate)).reshape(shape)


class BatchDropout(Dropout):
    """The step's dropout over rows [``row0``, ...) of the batch: seeds
    drawn from ``gen`` in the forward's order on the first pass and kept in
    ``seeds``, replayed by every later block (``restart``). A tensor whose
    first dimension is the batch's rows is hashed at its index in the whole
    batch's tensor; ``shared`` calls (the relative table) at their own."""

    def __init__(self, rate: float, gen: torch.Generator | None):
        super().__init__(rate, gen)
        self.seeds, self.at, self.row0 = [], 0, 0

    def restart(self, row0: int) -> None:
        self.at, self.row0 = 0, int(row0)

    def seed(self) -> int:
        if self.at == len(self.seeds):
            self.seeds.append(super().seed())
        self.at += 1
        return self.seeds[self.at - 1]

    def __call__(self, x: torch.Tensor, shared: bool = False) -> torch.Tensor:
        if not self.on:
            return x
        offset = 0 if shared else self.row0 * int(np.prod(x.shape[1:]))
        return x * flat_keep_at(self.seed(), x.shape, self.rate, offset, x.device)


def relpos_table(t: int, d: int, device) -> torch.Tensor:
    """(2T - 1, d): row r the sinusoid of relative position T - 1 - r, sin
    on even dims, cos on odd, 10000^(-2m/d), in float64 -> float32."""
    pos = np.arange(t - 1, -t, -1, dtype=np.float64)[:, None]
    m = np.arange(d)[None, :] // 2
    angle = pos * np.power(10000.0, -2.0 * m / d)
    table = np.where(np.arange(d)[None, :] % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32)).to(device)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """ESPnet's ``RelPositionMultiHeadedAttention.rel_shift``: (B, H, T,
    2T - 1) -> (B, H, T, T), [i, j] <- [i, T - 1 - i + j], by a zero
    column, a view of another shape and a slice."""
    zero_pad = torch.zeros((*x.size()[:3], 1), device=x.device, dtype=x.dtype)
    x_padded = torch.cat([zero_pad, x], dim=-1)
    x_padded = x_padded.view(*x.size()[:2], x.size(3) + 1, x.size(2))
    return x_padded[:, :, 1:].view_as(x)[:, :, :, : x.size(-1) // 2 + 1]


class ConformerModel(Model):
    """The reference rel-pos conformer for a configuration's ``model``
    section over weights ``w``; ``prec`` rounds the products' operands."""

    def conv(self, x, name, **kw):
        """``F.conv2d`` (4-d ``x``) or ``F.conv1d`` with the leaf ``name``."""
        f = F.conv2d if x.dim() == 4 else F.conv1d
        return f(self.p(x), self.p(self.w[f"{name}.weight"]), self.w[f"{name}.bias"], **kw)

    def subsample(self, feats, lengths):
        y = feats[:, None]
        for conv in ("conv0", "conv1"):
            y = torch.relu(self.conv(y, f"encoder.frontend_mod.{conv}", stride=2))
        b, c, t, f = y.shape
        y = self.dense(y.permute(0, 2, 3, 1).reshape(b, t, f * c), "encoder.frontend_mod.proj")
        return y, (((lengths - 1) // 2) - 1) // 2

    def ffn(self, x, name, drop):
        """Swish in the encoder's macaron FFNs, ReLU in the decoder's."""
        act = F.silu if name.startswith("encoder.") else torch.relu
        return drop(self.dense(act(self.dense(x, f"{name}.w1")), f"{name}.w2"))

    def relpos_attention(self, name, x, table, keys, drop):
        b, t, _ = x.shape
        split = lambda y, n: y.reshape(b, n, self.h, self.dk).transpose(1, 2)
        q = self.dense(x, f"{name}.q_proj").reshape(b, t, self.h, self.dk)
        k = split(self.dense(x, f"{name}.k_proj"), t)
        v = split(self.dense(x, f"{name}.v_proj"), t)
        p = self.p.linear(table, self.w[f"{name}.linear_pos.weight"])
        p = p.reshape(1, -1, self.h, self.dk).transpose(1, 2)
        qu = (q + self.w[f"{name}.pos_bias_u"]).transpose(1, 2)
        qv = (q + self.w[f"{name}.pos_bias_v"]).transpose(1, 2)
        ac = self.p.einsum("bhid,bhjd->bhij", qu, k)
        bd = rel_shift(self.p.einsum("bhid,xhrd->bhir", qv, p))
        scores = (ac + bd) / math.sqrt(self.dk)
        masked = ~keys[:, None, None, :]
        scores = scores.masked_fill(masked, torch.finfo(scores.dtype).min)
        wts = torch.softmax(scores, dim=-1).masked_fill(masked, 0.0)
        out = self.p.einsum("bhij,bhjd->bhid", wts, v).transpose(1, 2).reshape(b, t, -1)
        return drop(self.dense(out, f"{name}.out_proj"))

    def conv_module(self, x, name, keys, drop):
        y = F.glu(self.dense(x, f"{name}.pw1"), dim=-1) * keys[:, :, None].float()
        k = self.w[f"{name}.dw.weight"].shape[-1]
        y = self.conv(y.transpose(1, 2), f"{name}.dw", groups=self.d, padding=(k - 1) // 2)
        y = self.norm(y.transpose(1, 2), f"{name}.norm")
        return drop(self.dense(F.silu(y), f"{name}.pw2"))

    def encode(self, feats, lengths, drop: Dropout | None = None):
        drop = drop or BatchDropout(0.0, None)
        x, lengths = self.subsample(feats, lengths)
        t = x.shape[1]
        x = drop(x * math.sqrt(self.d))
        table = drop(relpos_table(t, self.d, x.device), shared=True)
        keys = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        for i in range(self.cfg["num_encoder_layers"]):
            p = f"encoder.layers.{i}"
            x = x + 0.5 * self.ffn(self.norm(x, f"{p}.ln_ffn1"), f"{p}.ffn1", drop)
            x = x + self.relpos_attention(f"{p}.attn", self.norm(x, f"{p}.ln_attn"), table,
                                          keys, drop)
            x = x + self.conv_module(self.norm(x, f"{p}.ln_conv"), f"{p}.conv", keys, drop)
            x = x + 0.5 * self.ffn(self.norm(x, f"{p}.ln_ffn2"), f"{p}.ffn2", drop)
            x = self.norm(x, f"{p}.ln_final")
        return self.norm(x, "encoder.final_norm"), lengths

    def attention(self, name, xq, xkv, allow, drop: Dropout, pair_hash: bool):
        """The decoder's attention, as ``Model.attention`` without the
        weights' dropout."""
        b, tq, _ = xq.shape
        tk = xkv.shape[1]
        split = lambda y, t: y.reshape(b, t, self.h, self.dk).transpose(1, 2)
        q = split(self.dense(xq, f"{name}.q_proj"), tq)
        k = split(self.dense(xkv, f"{name}.k_proj"), tk)
        v = split(self.dense(xkv, f"{name}.v_proj"), tk)
        s = self.p.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(self.dk)
        wts = torch.softmax(s + torch.where(allow, 0.0, NEG), dim=-1)
        out = self.p.einsum("bhqk,bhkd->bhqd", wts, v).transpose(1, 2).reshape(b, tq, -1)
        return drop(self.dense(out, f"{name}.out_proj"))


def smoothed_ce_sum(logits, gold, eps: float):
    """(the sum over the non-PAD targets of the smoothed CE, each row's mean
    over its own)."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (gold != 0).float()
    q = torch.full_like(logp, eps / v)
    q.scatter_(-1, gold[..., None], 1.0 - eps)
    per_pos = -(q * logp).sum(-1) * mask
    return per_pos.sum(), per_pos.sum(1) / mask.sum(1).clamp(min=1.0)


class ConformerTrainer:
    """The reference's training state for the rel-pos conformer: f32 leaves
    and Adam's moments; a step runs the batch in blocks of ``block_rows``
    rows (0: whole), each with its rows' dropout masks, summing the
    gradients, then clips and steps Adam on the Noam schedule as
    ``train.Trainer`` does."""

    def __init__(self, model_cfg: dict, weights: dict, train: dict, feat: dict,
                 prec: Precision | None = None, block_rows: int = 0):
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.model = ConformerModel(model_cfg, self.params, prec)
        self.train, self.feat, self.count = train, feat, 0
        self.block_rows = int(block_rows)

    def forward_loss(self, batch: dict, seed: int, backward: bool = True):
        """(the step's loss, each utterance's loss), the gradients left in
        the leaves' ``.grad`` when ``backward``."""
        from .features import features
        from .train import step_generators

        aug, drop_gen = step_generators(seed, self.count)
        feats, lengths = features(batch["wave"], batch["wave_lengths"], self.feat,
                                  aug if self.train.get("spec_augment") else None)
        cfg = self.model.cfg
        drop = BatchDropout(cfg["dropout_rate"], drop_gen)
        w_ctc, eps = float(cfg["ctc_weight"]), float(cfg.get("label_smoothing", 0.0))
        labels, label_lengths = batch["labels"], batch["label_lengths"]
        _, gold_all = targets(labels, label_lengths)
        n_word = float((gold_all != 0).sum())
        n = feats.shape[0]
        step = self.block_rows or n
        loss, rows = 0.0, []
        for r0 in range(0, n, step):
            sl = slice(r0, min(n, r0 + step))
            drop.restart(r0)
            enc, enc_len = self.model.encode(feats[sl], lengths[sl], drop)
            ys_in, gold = targets(labels[sl], label_lengths[sl])
            logits = self.model.decode(ys_in, label_lengths[sl] + 1, enc, enc_len, drop)
            ce_sum, ce_rows = smoothed_ce_sum(logits, gold, eps)
            logp = torch.log_softmax(self.model.ctc_logits(enc).float(), dim=-1).transpose(0, 1)
            nll = F.ctc_loss(logp, labels[sl].long(), enc_len.long(),
                             label_lengths[sl].long(), blank=0, reduction="none")
            part = w_ctc * nll.sum() / n + (1.0 - w_ctc) * ce_sum / n_word
            if backward:
                part.backward()
            loss += float(part.detach())
            rows.append((w_ctc * nll + (1.0 - w_ctc) * ce_rows).detach())
            del enc, logits, logp, nll, part
        return loss, torch.cat(rows)

    def step(self, batch: dict, seed: int) -> dict:
        """One update; returns its loss, each utterance's loss, the
        gradient's global norm before the clip and each leaf's clipped
        gradient."""
        from .train import noam

        for p in self.params.values():
            p.grad = None
        loss, rows = self.forward_loss(batch, seed)
        grads = {k: p.grad.detach() for k, p in self.params.items()}
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        max_norm = float(self.train["grad_clip"])
        scale = 1.0 if float(norm) < max_norm else max_norm / float(norm)
        b1, b2, eps = self.train["adam_b1"], self.train["adam_b2"], self.train["adam_eps"]
        lr = noam(self.model.d, self.train["warmup"], self.train["noam_factor"], self.count)
        t = self.count + 1
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] * scale
                grads[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (self.v[k] / (1.0 - b2 ** t)).sqrt() + eps
                p.sub_(lr / (1.0 - b1 ** t) * self.m[k] / denom)
        self.count += 1
        return {"loss": loss, "rows": rows.double().cpu().tolist(), "grad_norm": float(norm),
                "grads": grads}
