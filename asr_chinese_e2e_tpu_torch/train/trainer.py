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

``eval_decode`` (none | ctc_greedy | attention_greedy | beam | joint, beam
width ``eval_beam_size``) adds a decoded CER: ``evaluate`` re-encodes each
batch, decodes it in that mode and records ``decoded_cer`` beside the
teacher-forced ``cer`` (which a model without teacher-forced logits, as
BiLSTMCTC, does not record).

Left out of the port (ROADMAP §1): the device mesh, ``steps_per_dispatch``
and in-flight pacing (TPU remote-link workarounds), and xprof tracing.
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
from ..data.features import parse_batch
from ..decode.beam import beam_search
from ..decode.cer import batch_cer_from_ids, corpus_cer
from ..decode.greedy import attention_greedy_decode, ctc_greedy_decode, tokens_to_ids
from ..decode.joint import joint_beam_search
from .checkpoint import CheckpointManager
from .metrics import MetricsAccumulator, ScalarWriter, ThroughputMeter
from .optimizer import Optimizer, current_lr, model_width
from .train_step import make_step_fns


EVAL_DECODE_MODES = ("none", "ctc_greedy", "attention_greedy", "beam", "joint")


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
        self._eval_decode = cfg.get("eval_decode", "none")
        if self._eval_decode not in EVAL_DECODE_MODES:
            raise ValueError(f"unknown eval_decode {self._eval_decode!r}")
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
        # Noam's width: the RNN family has hidden_size and no d_model
        self._d_model = model_width(cfg)
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
            arrays = self._put_batch(batch)
            metrics = self.eval_step(*arrays)
            names = [k for k in metrics if k not in ("pred_ids", "gold_ids")]
            values = torch.stack([metrics[k].float() for k in names]).tolist()
            host = dict(zip(names, values))
            if "pred_ids" in metrics:
                host["cer"] = batch_cer_from_ids(
                    metrics["pred_ids"].cpu().numpy(), metrics["gold_ids"].cpu().numpy(),
                    self.vocab,
                )
            if self._eval_decode != "none":
                host["decoded_cer"] = corpus_cer(self._decode(*arrays[:2]), batch.texts)
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

    @torch.inference_mode()
    def _decode(self, wave, wave_lengths) -> list:
        """Re-encode one eval batch and decode it in the ``eval_decode``
        mode; returns the hypothesis texts."""
        model = self.model
        feats, feat_lens = parse_batch(wave, wave_lengths, self.feat_cfg)
        enc_out, enc_lens = model.encode(feats, feat_lens)
        max_len = self.cfg.get("max_target_len", 64)
        beam = self.cfg.get("eval_beam_size", 10)
        if self._eval_decode == "ctc_greedy":
            hyp_ids = ctc_greedy_decode(model.ctc_log_probs(enc_out), enc_lens)
        elif self._eval_decode == "attention_greedy":
            tokens, _ = attention_greedy_decode(model, enc_out, enc_lens, max_len)
            hyp_ids = tokens_to_ids(tokens)
        else:
            if self._eval_decode == "beam":
                res = beam_search(model, enc_out, enc_lens, beam, max_len)
            else:
                # the configured weight as it is: 0 is the attention beam
                # over the pruned candidates
                res = joint_beam_search(
                    model, enc_out, enc_lens, beam, max_len,
                    ctc_weight=float(self.cfg.get("ctc_weight", 0.3)),
                )
            hyp_ids = [h[0] for h in res.nbest_ids(1)]
        return ["".join(self.vocab.ids_to_tokens(ids)) for ids in hyp_ids]

    def save(self, metric: Optional[float] = None,
             resume_epoch: Optional[int] = None) -> str:
        return self.ckpt.save(
            self.state,
            self.epoch if resume_epoch is None else resume_epoch,
            config=self.cfg,
            vocab_fingerprint=self.vocab.fingerprint() if self.vocab else None,
            metric=metric,
        )
