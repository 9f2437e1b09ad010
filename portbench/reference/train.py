"""Plain training step: features (with SpecAugment) -> forward with dropout
-> ctc_weight x CTC (per-utterance NLL, mean over the batch) + (1 -
ctc_weight) x label-smoothed cross-entropy (target one-hot x (1 - eps) +
eps / V elsewhere, mean over non-PAD positions) -> gradients by autograd ->
clip by global norm (scaled by max / norm only when norm >= max) -> Adam on
the Noam schedule, update n at lr(n + 1).

A step's randomness comes from two CPU generators seeded by numpy's
SeedSequence of (seed, step, 0): the first draws SpecAugment's masks, the
second the dropout seeds."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .features import features
from .model import Dropout, Model
from .precision import Precision


def step_generators(seed: int, step: int):
    s_aug, s_drop = np.random.SeedSequence([int(seed), int(step), 0]).generate_state(2)
    return torch.Generator().manual_seed(int(s_aug)), torch.Generator().manual_seed(int(s_drop))


def noam(d_model: int, warmup: int, factor: float, count: int) -> float:
    step = float(count + 1)
    return factor * d_model ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def smoothed_ce(logits, gold, eps: float):
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (gold != 0).float()
    if eps > 0.0:
        q = torch.full_like(logp, eps / v)
        q.scatter_(-1, gold[..., None], 1.0 - eps)
    else:
        q = F.one_hot(gold, v).float()
    per_pos = -(q * logp).sum(-1)
    return (per_pos * mask).sum() / mask.sum().clamp(min=1.0)


def loss_of(model: Model, batch: dict, feat: dict, train: dict, seed: int, step: int):
    aug, drop_gen = step_generators(seed, step)
    feats, lengths = features(batch["wave"], batch["wave_lengths"], feat,
                              aug if train.get("spec_augment") else None)
    drop = Dropout(model.cfg["dropout_rate"], drop_gen)
    _, enc_len, ctc, logits, gold = model.forward(
        feats, lengths, batch["labels"], batch["label_lengths"], drop)
    w_ctc = float(model.cfg.get("ctc_weight", 0.0))
    ce = smoothed_ce(logits, gold, float(model.cfg.get("label_smoothing", 0.0)))
    if ctc is None or w_ctc == 0.0:
        return ce
    logp = torch.log_softmax(ctc.float(), dim=-1).transpose(0, 1)
    nll = F.ctc_loss(logp, batch["labels"].long(), enc_len.long(),
                     batch["label_lengths"].long(), blank=0, reduction="none")
    return w_ctc * nll.mean() + (1.0 - w_ctc) * ce


class Trainer:
    """The reference's training state: f32 leaves and Adam's moments."""

    def __init__(self, model_cfg: dict, weights: dict, train: dict, feat: dict,
                 prec: Precision | None = None):
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.model = Model(model_cfg, self.params, prec)
        self.train, self.feat, self.count = train, feat, 0

    def step(self, batch: dict, seed: int) -> dict:
        """One update; returns its loss, the gradient's global norm before
        the clip and the clipped gradient of each leaf."""
        for p in self.params.values():
            p.grad = None
        loss = loss_of(self.model, batch, self.feat, self.train, seed, self.count)
        loss.backward()
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
        return {"loss": float(loss.detach()), "grad_norm": float(norm), "grads": grads}
