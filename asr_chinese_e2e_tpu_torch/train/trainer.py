"""Epoch-based trainer on one device (``asr_chinese_e2e_tpu/train/trainer.py``).

Parity with the reference trainer's cadences (``Trainer/trainer11.py``):
per step a train step; every ``log_every_iter`` steps the train metric
means, the learning rate and the throughput go to ``scalars.jsonl``;
every ``eval_every_iter`` a dev evaluation; every ``save_every_iter`` a
checkpoint; at each epoch end a dev and a test evaluation and a
checkpoint, with the best pointer driven by the dev metric
(``reference='-loss'``). ``train(from_ckpt=...)`` resumes model, optimizer
(with the schedule's update count), step and epoch. A non-finite loss in
a log window raises.

Left out of the port (ROADMAP §1): the device mesh, ``steps_per_dispatch``
and in-flight pacing (TPU remote-link workarounds), xprof tracing, and
decoding modes in evaluation other than ``eval_decode="none"`` (item 3).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Optional

import torch

from ..core.config import Config
from ..data.batching import Batch, BucketedLoader
from ..data.features import FeatureConfig
from ..decode.cer import batch_cer_from_ids
from .checkpoint import CheckpointManager
from .metrics import MetricsAccumulator, ScalarWriter, ThroughputMeter
from .optimizer import Optimizer, current_lr
from .train_step import make_step_fns


def default_exp_name() -> str:
    return datetime.datetime.now().strftime("%Y%m%d_%H%M%S")


class Trainer:
    def __init__(
        self,
        model,
        optimizer: Optimizer,
        cfg: Config,
        feat_cfg: FeatureConfig,
        vocab,
        train_loader: BucketedLoader,
        dev_loader: Optional[BucketedLoader] = None,
        test_loader: Optional[BucketedLoader] = None,
    ) -> None:
        eval_decode = cfg.get("eval_decode", "none")
        if eval_decode != "none":
            raise NotImplementedError(
                f"eval_decode={eval_decode!r} is not ported yet (ROADMAP §1, item 3: "
                "the remaining recognize modes)"
            )
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.feat_cfg, self.vocab = feat_cfg, vocab
        self.train_loader = train_loader
        self.dev_loader, self.test_loader = dev_loader, test_loader
        self.device = next(model.parameters()).device
        exp_name = cfg.get("exp_name") or default_exp_name()
        self.exp_dir = os.path.join(cfg.get("exp_root", "ckpt"), exp_name)
        if cfg.get("drop_exp", False) and os.path.isdir(self.exp_dir):
            import shutil

            shutil.rmtree(self.exp_dir)
        os.makedirs(self.exp_dir, exist_ok=True)
        cfg.save(os.path.join(self.exp_dir, "config.json"))
        self.writer = ScalarWriter(self.exp_dir)
        self.ckpt = CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            reference=cfg.get("reference", "-loss"),
            export_dir=self.exp_dir,
        )
        self.init_fn, self.train_step, self.eval_step = make_step_fns(
            model, optimizer, feat_cfg, cfg
        )
        self.seed = int(cfg.get("seed", 0))
        self.state = None
        self.epoch = 0
        self._d_model = cfg.get("d_model", 512)
        self.throughput = ThroughputMeter(1)

    def _put_batch(self, batch: Batch) -> list:
        dev = self.device
        return [
            torch.from_numpy(x).to(dev, non_blocking=True)
            for x in (batch.wave, batch.wave_lengths, batch.labels, batch.label_lengths)
        ]

    def train(self, from_ckpt: Optional[str] = None) -> None:
        """Full training run; ``from_ckpt`` in {'latest', 'best',
        'e{E}_s{S}'} resumes."""
        self.state = self.init_fn()
        if from_ckpt is not None:
            meta = self.ckpt.restore(from_ckpt, self.state)
            self.epoch = int(meta["epoch"])
        for epoch in range(self.epoch, self.cfg.num_epoch):
            self.epoch = epoch
            self.train_epoch(epoch)
            # best-checkpoint selection by the dev metric; test is reporting
            metric = None
            if self.dev_loader is not None:
                metric = self.evaluate(self.dev_loader, "dev/")
            if self.test_loader is not None:
                test_metric = self.evaluate(self.test_loader, "test/")
                if self.dev_loader is None:
                    metric = test_metric
            # end-of-epoch checkpoints resume at the next epoch
            self.save(metric, resume_epoch=epoch + 1)

    def train_epoch(self, epoch: int) -> None:
        cfg = self.cfg
        state = self.state
        self.throughput.reset()
        sr = self.feat_cfg.sample_rate
        # re-zero the metric sums each epoch (bounded f32 accumulation)
        for v in state.metric_sums.values():
            v.zero_()
        sums_base = {k: 0.0 for k in state.metric_sums}
        for batch in self.train_loader.epoch(epoch):
            step_before = state.step
            self.train_step(state, *self._put_batch(batch), self.seed)
            self.throughput.step(float(batch.wave_lengths.sum()) / sr)
            step = state.step
            if step % cfg.log_every_iter == 0:
                names = list(state.metric_sums)
                values = torch.stack([state.metric_sums[k] for k in names]).tolist()
                sums = dict(zip(names, values))
                n = sums["_n"] - sums_base["_n"]
                means = {
                    k: (sums[k] - sums_base[k]) / max(n, 1.0) for k in sums if k != "_n"
                }
                sums_base = sums
                if not math.isfinite(means.get("loss", 0.0)):
                    raise ValueError("nan loss encountered")
                scalars = {f"train/{k}": v for k, v in means.items()}
                scalars["lr"] = current_lr(cfg, self._d_model, step)
                scalars["train/audio_s_per_s_per_chip"] = (
                    self.throughput.audio_seconds_per_sec_per_chip
                )
                scalars["train/steps_per_s"] = self.throughput.steps_per_sec
                self.writer.write(step, scalars)
            if (
                self.dev_loader is not None and cfg.eval_every_iter
                and step // cfg.eval_every_iter > step_before // cfg.eval_every_iter
            ):
                self.evaluate(self.dev_loader, "dev/")
            if (
                cfg.save_every_iter
                and step // cfg.save_every_iter > step_before // cfg.save_every_iter
            ):
                self.save()

    def evaluate(self, loader: BucketedLoader, prefix: str = "dev/"):
        """Sample-weighted metric means plus teacher-forced CER over a
        loader; returns the reference metric (None for an empty loader)."""
        acc = MetricsAccumulator()
        for batch in loader.epoch(0):
            metrics = self.eval_step(*self._put_batch(batch))
            names = [k for k in metrics if k not in ("pred_ids", "gold_ids")]
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            host = dict(zip(names, values))
            host["cer"] = batch_cer_from_ids(
                metrics["pred_ids"].cpu().numpy(), metrics["gold_ids"].cpu().numpy(),
                self.vocab,
            )
            acc.update(host, num_samples=len(batch.texts))
        means = acc.means()
        if not means:
            import warnings

            warnings.warn(
                f"evaluate({prefix!r}) saw zero batches — eval loader produced "
                "nothing (check drop_last/bucket fill)",
                stacklevel=2,
            )
            return None
        self.writer.write(self.state.step, {prefix + k: v for k, v in means.items()})
        key = self.cfg.get("reference", "-loss").lstrip("+-")
        return means.get(key, means.get("loss", 0.0))

    def save(self, metric: Optional[float] = None,
             resume_epoch: Optional[int] = None) -> str:
        return self.ckpt.save(
            self.state,
            self.epoch if resume_epoch is None else resume_epoch,
            config=self.cfg,
            vocab_fingerprint=self.vocab.fingerprint() if self.vocab else None,
            metric=metric,
        )
