"""The train and eval steps (``asr_chinese_e2e_tpu/train/train_step.py``).

One step: waves -> features (fbank kernel, CMVN, SpecAugment, LFR) ->
teacher-forced model with dropout -> 0.3*CTC + 0.7*smoothed CE -> backward
-> global-norm clip -> Adam on the schedule. PyTorch runs eagerly, so
there is no compiled step: the functions run the same sequence of
(kernel) launches every call.

- Per-step randomness (SpecAugment masks, dropout seeds) comes from CPU
  generators seeded by (seed, step), the counterpart of ``fold_in(rng,
  state.step)``: a step's draws do not depend on how many steps ran in
  this process.
- ``grad_norm`` is taken before clipping.
- ``grad_accum`` > 1 averages the gradients of equal-weighted
  microbatches (losses averaged, counts summed), as the JAX package does.
- Metric sums stay on the device (weighted by batch size, with the sample
  count under ``"_n"``); the trainer reads them at log cadence.
- Spans (``utils/debug.py``, recorded under a profiler): ``train_step``
  a call, with the step's number as its request, and under it
  ``train.features``, ``train.forward``, ``train.loss``,
  ``train.backward``, ``train.optimizer`` and ``train.metric_sums``.

Under an active mesh (``parallel/context.py``) with a ``data`` axis the
batch is this rank's rows of the global batch: the counts the losses
divide by are summed over the axis first (``model_loss(totals=...)``), so
the ranks' gradients sum to the global batch's; ``Optimizer.step`` sums
them over the axis before the norm and the clip; the metrics are summed
over it too, so every rank holds the global batch's. SpecAugment and rng
dropout draw per rank (the rank folded into the generator), hash dropout
by global element index (``models/layers.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import Config
from ..data.features import FeatureConfig, parse_batch
from ..data.vocab import IGNORE_ID
from ..losses import model_loss
from ..parallel.collectives import all_reduce_sum
from ..parallel.context import get_active_mesh
from ..utils.debug import annotate
from .optimizer import Optimizer


@dataclasses.dataclass
class TrainState:
    """The model (float32 master weights), its optimizer, the number of
    steps taken, and the on-device metric sums."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int
    metric_sums: dict


def step_generators(seed: int, step: int, micro: int = 0, rank: int = 0):
    """(augment, dropout) CPU generators for one (micro)step, seeded from
    (seed, step, micro) through numpy's SeedSequence; a data rank > 0 draws
    its own augment masks (its rows are not rank 0's)."""
    s_aug, s_drop = np.random.SeedSequence([int(seed), int(step), int(micro)]).generate_state(2)
    if rank:
        s_aug = np.random.SeedSequence([int(seed), int(step), int(micro), int(rank)]).generate_state(1)[0]
    return (
        torch.Generator().manual_seed(int(s_aug)),
        torch.Generator().manual_seed(int(s_drop)),
    )


def metric_keys(cfg: Config, has_ctc_head: bool) -> tuple:
    """The metric names ``train_step`` emits (``model_loss``'s branches
    plus ``grad_norm``)."""
    ctc_weight = float(cfg.get("ctc_weight", 0.0))
    keys = ["loss", "grad_norm"]
    if ctc_weight < 1.0:
        keys += ["ce_loss", "n_correct", "n_word"]
    if has_ctc_head and ctc_weight > 0.0:
        keys += ["ctc_loss"]
    return tuple(sorted(keys))


def make_step_fns(model, optimizer: Optimizer, feat_cfg: FeatureConfig, cfg: Config,
                  raw_features: bool = False):
    """Build (init_fn, train_step, eval_step) for ``model`` (already on its
    device, float32 weights). ``raw_features=True`` feeds features instead
    of waveforms."""
    ctc_weight = float(cfg.get("ctc_weight", 0.0))
    smoothing = float(cfg.get("label_smoothing", 0.0))
    use_specaug = bool(cfg.get("spec_augment", False))
    ctc_impl = cfg.get("ctc_impl", "pallas")
    grad_accum = int(cfg.get("grad_accum", 1))
    keys = metric_keys(cfg, getattr(model, "ctc_head", None) is not None)

    def featurize(wave, wave_lengths, generator):
        if raw_features:
            return wave, wave_lengths
        return parse_batch(
            wave, wave_lengths, feat_cfg, augment=generator is not None,
            generator=generator,
        )

    def init_fn() -> TrainState:
        dev = next(model.parameters()).device
        sums = {k: torch.zeros((), device=dev) for k in keys + ("_n",)}
        return TrainState(model=model, optimizer=optimizer, step=0, metric_sums=sums)

    def data_group():
        mesh = get_active_mesh()
        return None if mesh is None else mesh.group("data")

    def global_totals(out, wave, group):
        """(utterances, non-PAD targets) of the global batch, or None when
        this rank holds all of it."""
        if group is None:
            return None
        gold = out.get("gold")
        n_word = float(0) if gold is None else (gold != IGNORE_ID).sum().float()
        counts = torch.stack([torch.tensor(float(wave.shape[0]), device=wave.device),
                              torch.as_tensor(n_word, device=wave.device)])
        counts = all_reduce_sum(counts, group)
        return counts[0], counts[1]

    def _backward(wave, wave_lengths, labels, label_lengths, gens, weight):
        """Forward with dropout, loss, backward (gradients accumulate in
        ``.grad`` scaled by ``weight``); returns detached metrics."""
        aug_gen, drop_gen = gens
        with annotate("train.features"):
            feats, feat_lens = featurize(wave, wave_lengths, aug_gen if use_specaug else None)
        with annotate("train.forward"):
            out = model(feats, feat_lens, labels, label_lengths, rng=drop_gen)
        with annotate("train.loss"):
            totals = global_totals(out, wave, data_group())
            loss, metrics = model_loss(out, labels, label_lengths, ctc_weight, smoothing,
                                       ctc_impl, totals)
        with annotate("train.backward"):
            (loss * weight if weight != 1.0 else loss).backward()
        return {k: v.detach() for k, v in metrics.items()}

    def reduce_metrics(metrics: dict, group) -> dict:
        """The global batch's metrics from the ranks' parts (the losses are
        already over the global counts: their parts sum)."""
        if group is None:
            return metrics
        names = sorted(metrics)
        vec = all_reduce_sum(torch.stack([metrics[k].float() for k in names]), group)
        return dict(zip(names, vec.unbind(0)))

    def train_step(state: TrainState, wave, wave_lengths, labels, label_lengths, seed):
        with annotate("train_step", request=state.step):
            model.train()
            optimizer.zero_grad()
            group = data_group()
            rank = get_active_mesh().index("data") if group is not None else 0
            if grad_accum == 1:
                metrics = _backward(
                    wave, wave_lengths, labels, label_lengths,
                    step_generators(seed, state.step, rank=rank), 1.0,
                )
            else:
                bsz = wave.shape[0]
                if bsz % grad_accum:
                    raise ValueError(
                        f"batch size {bsz} is not divisible by grad_accum={grad_accum}"
                    )
                mb = bsz // grad_accum
                per_micro = []
                for i in range(grad_accum):
                    sl = slice(i * mb, (i + 1) * mb)
                    per_micro.append(_backward(
                        wave[sl], wave_lengths[sl], labels[sl], label_lengths[sl],
                        step_generators(seed, state.step, i + 1, rank), 1.0 / grad_accum,
                    ))
                metrics = {
                    k: (torch.stack([m[k] for m in per_micro]).sum(0)
                        if k in ("n_correct", "n_word")
                        else torch.stack([m[k] for m in per_micro]).mean(0))
                    for k in per_micro[0]
                }
            metrics = reduce_metrics(metrics, group)
            with annotate("train.optimizer"):
                metrics["grad_norm"] = optimizer.step(group)
            with annotate("train.metric_sums"):
                n = float(wave.shape[0]) * (
                    1 if group is None else get_active_mesh().shape["data"])
                sums = state.metric_sums
                sums["_n"] += n
                for k in keys:
                    sums[k] += metrics[k].float() * n
            state.step += 1
            return state, metrics

    @torch.no_grad()
    def eval_step(wave, wave_lengths, labels, label_lengths):
        model.eval()
        feats, feat_lens = featurize(wave, wave_lengths, None)
        out = model(feats, feat_lens, labels, label_lengths)
        group = data_group()
        _, metrics = model_loss(out, labels, label_lengths, ctc_weight, smoothing, ctc_impl,
                                global_totals(out, wave, group))
        metrics = reduce_metrics(metrics, group)
        if "logits" in out:
            # teacher-forced argmax ids for host-side CER at eval cadence
            # (a CTC-only model has none)
            metrics["pred_ids"] = out["logits"].argmax(dim=-1)
            metrics["gold_ids"] = out["gold"]
        return metrics

    return init_fn, train_step, eval_step
