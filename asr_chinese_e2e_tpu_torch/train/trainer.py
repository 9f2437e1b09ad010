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

``raw_features=True`` trains and evaluates on cached features (a
``BucketedLoader`` over a ``preprocess features`` manifest with
``feat_cfg``): no fbank, no SpecAugment, and ``eval_decode`` encodes the
batch as it comes. ``profile_from_step`` / ``profile_steps`` open one
``utils/debug.py::profile_trace`` over the train steps in ``[from, from +
steps)``, written to ``exp_dir/trace/``, where each step shows as its own
``train_step`` span (``utils/debug.py``); the trace closes at the epoch's
end if still open.

``mesh`` (``parallel/sharding.py::make_mesh``) trains across processes,
one per device, as the JAX package's trainer does across devices:

- ``data``: each rank trains its rows of the global batch (the loader's
  batch is the global one, or, with ``num_hosts`` > 1, this data rank's
  shard of the manifest). Losses are normalised over the global batch,
  gradients summed over the axis before the norm and the clip, metric
  sums are the global batch's. An evaluation batch that does not divide
  the axis runs whole on every rank. ``eval_decode="beam"`` decodes
  through ``decode/distributed.py::distributed_beam_search``.
- ``model``: the model is split by ``shard_model_`` (tensor parallelism);
  checkpoints hold whole tensors (gathered before a save, cut on restore).
- ``seq``: ``attn_impl="ring"`` runs ring attention over the axis.

Rank 0 alone writes ``config.json``, ``scalars.jsonl`` and the
checkpoints; every rank restores. ``ThroughputMeter`` counts every rank.

Left out of the port (ROADMAP §1): ``steps_per_dispatch`` and in-flight
pacing (TPU remote-link workarounds).
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import Config
from ..data.batching import Batch, BucketedLoader
from ..data.features import FeatureConfig
from ..data.features import parse_batch
from ..decode.beam import beam_search
from ..decode.cer import batch_cer_from_ids, corpus_cer
from ..decode.greedy import attention_greedy_decode, ctc_greedy_decode, tokens_to_ids
from ..decode.distributed import distributed_beam_search
from ..decode.joint import joint_beam_search
from ..parallel import sharding
from ..parallel.context import active_mesh
from ..utils.debug import profile_trace
from .checkpoint import CheckpointManager
from .metrics import MetricsAccumulator, NullScalarWriter, ScalarWriter, ThroughputMeter
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
        raw_features: bool = False,
        mesh=None,
    ) -> None:
        self._eval_decode = cfg.get("eval_decode", "none")
        if self._eval_decode not in EVAL_DECODE_MODES:
            raise ValueError(f"unknown eval_decode {self._eval_decode!r}")
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.feat_cfg, self.vocab = feat_cfg, vocab
        self.train_loader = train_loader
        self.dev_loader, self.test_loader = dev_loader, test_loader
        self.device = next(model.parameters()).device
        self.mesh = mesh
        self.rank0 = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
        if mesh is not None and mesh.shape["model"] > 1:
            if not sharding.sharded_parameters(model):  # not split by the caller
                sharding.shard_model_(model, mesh)
            optimizer.set_tensor_parallel(mesh.group("model"),
                                          sharding.sharded_parameters(model))
        exp_name = cfg.get("exp_name") or default_exp_name()
        self.exp_dir = os.path.join(cfg.get("exp_root", "ckpt"), exp_name)
        if self.rank0 and cfg.get("drop_exp", False) and os.path.isdir(self.exp_dir):
            import shutil

            shutil.rmtree(self.exp_dir)
        self._barrier()
        os.makedirs(self.exp_dir, exist_ok=True)
        if self.rank0:
            cfg.save(os.path.join(self.exp_dir, "config.json"))
            self.writer = ScalarWriter(self.exp_dir)
        else:
            self.writer = NullScalarWriter()
        self.ckpt = CheckpointManager(
            os.path.join(self.exp_dir, "checkpoints"),
            reference=cfg.get("reference", "-loss"),
            export_dir=self.exp_dir, writer=self.rank0,
        )
        self.init_fn, self.train_step, self.eval_step = make_step_fns(
            model, optimizer, feat_cfg, cfg, raw_features=raw_features
        )
        self._raw_features = raw_features
        self.seed = int(cfg.get("seed", 0))
        self.state = None
        self.epoch = 0
        # Noam's width: the RNN family has hidden_size and no d_model
        self._d_model = model_width(cfg)
        self.throughput = ThroughputMeter(1 if mesh is None else mesh.size)

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            dist.barrier()

    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def _host_sharded(self, loader) -> bool:
        """Whether ``loader``'s batches are this data rank's already (a
        manifest shard per data rank)."""
        return self._dp() > 1 and getattr(loader, "num_hosts", 1) > 1

    def _view(self, batch: Batch, loader):
        """(this rank's arrays of ``batch``, the mesh they run under):
        its rows of a global batch under the mesh, or the whole batch under
        the mesh without ``data`` where the rows do not divide it."""
        arrays = (batch.wave, batch.wave_lengths, batch.labels, batch.label_lengths)
        mesh = self.mesh
        if mesh is not None and self._dp() > 1 and not self._host_sharded(loader):
            if len(batch.wave) % self._dp():
                mesh = mesh.without("data")
            else:
                arrays = sharding.shard_batch(mesh, list(arrays))
        return self._put(arrays), mesh

    def _put(self, arrays) -> list:
        dev = self.device
        return [torch.from_numpy(x).to(dev, non_blocking=True) for x in arrays]

    def _put_batch(self, batch: Batch) -> list:
        """The whole batch on the device (no mesh)."""
        return self._put((batch.wave, batch.wave_lengths, batch.labels, batch.label_lengths))

    def _gather_rows(self, items: list, mesh) -> list:
        """A per-row list of this rank's rows -> the global batch's, in rank
        order (as is where the batch ran whole)."""
        if mesh is None or mesh.shape["data"] == 1:
            return items
        out = [None] * mesh.shape["data"]
        dist.all_gather_object(out, items, group=mesh.group("data"))
        return [x for part in out for x in part]

    def _texts(self, batch: Batch, loader, mesh) -> list:
        """The global batch's transcripts."""
        if self._host_sharded(loader) and mesh.shape["data"] > 1:
            return self._gather_rows(list(batch.texts), mesh)
        return list(batch.texts)

    def train(self, from_ckpt: Optional[str] = None) -> None:
        """Full training run; ``from_ckpt`` in {'latest', 'best',
        'e{E}_s{S}'} resumes."""
        self.state = self.init_fn()
        if from_ckpt is not None:
            cut = None
            if self.mesh is not None and self.mesh.shape["model"] > 1:
                model, opt = self.model, self.optimizer

                def cut(model_state, optimizer_state):
                    return (sharding.slice_state(model, model_state),
                            sharding.slice_optimizer_state(model, opt, optimizer_state))
            meta = self.ckpt.restore(from_ckpt, self.state, cut)
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
        prof_from = int(cfg.get("profile_from_step", 0))
        prof_steps = int(cfg.get("profile_steps", 0))
        tracing = False
        # a trace window still open at the epoch's end closes with the stack
        with contextlib.ExitStack() as trace:
            for batch in self.train_loader.epoch(epoch):
                step_before = state.step
                # one-shot trace window [prof_from, prof_from + prof_steps)
                if (prof_steps and not tracing
                        and prof_from <= step_before < prof_from + prof_steps):
                    trace.enter_context(profile_trace(os.path.join(self.exp_dir, "trace")))
                    tracing = True
                arrays, mesh = self._view(batch, self.train_loader)
                with active_mesh(mesh):
                    self.train_step(state, *arrays, self.seed)
                if tracing and state.step >= prof_from + prof_steps:
                    trace.close()
                    tracing = False
                audio = float(batch.wave_lengths.sum()) / sr
                self.throughput.step(
                    audio * self._dp() if self._host_sharded(self.train_loader) else audio)
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
            arrays, mesh = self._view(batch, loader)
            with active_mesh(mesh):
                metrics = self.eval_step(*arrays)
                names = [k for k in metrics if k not in ("pred_ids", "gold_ids")]
                values = torch.stack([metrics[k].float() for k in names]).tolist()
                host = dict(zip(names, values))
                if "pred_ids" in metrics:
                    pred = self._gather_rows(list(metrics["pred_ids"].cpu().numpy()), mesh)
                    gold = self._gather_rows(list(metrics["gold_ids"].cpu().numpy()), mesh)
                    host["cer"] = batch_cer_from_ids(np.stack(pred), np.stack(gold), self.vocab)
                texts = self._texts(batch, loader, mesh)
                if self._eval_decode != "none":
                    hyps = self._decode(*arrays[:2], mesh=mesh)
                    host["decoded_cer"] = corpus_cer(hyps, texts)
            acc.update(host, num_samples=len(texts))
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
    def _decode(self, wave, wave_lengths, mesh=None) -> list:
        """Re-encode one eval batch and decode it in the ``eval_decode``
        mode; returns the hypothesis texts (of the global batch: ``beam``
        gathers its n-best over ``data`` in ``distributed_beam_search``,
        the other modes their texts). Cached features are encoded as they
        come."""
        model = self.model
        if self._raw_features:
            feats, feat_lens = wave, wave_lengths
        else:
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
            if self._eval_decode == "beam" and mesh is not None and mesh.shape["data"] > 1:
                res = distributed_beam_search(model, enc_out, enc_lens, beam, max_len, mesh,
                                              local_rows=True)
                return self._texts_of([h[0] for h in res.nbest_ids(1)])
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
        return self._gather_rows(self._texts_of(hyp_ids), mesh)

    def _texts_of(self, hyp_ids) -> list:
        return ["".join(self.vocab.ids_to_tokens(ids)) for ids in hyp_ids]

    def save(self, metric: Optional[float] = None,
             resume_epoch: Optional[int] = None) -> str:
        """Checkpoint the state (whole tensors: a split model's chunks are
        gathered first; rank 0 writes, every rank waits for it)."""
        model_state = optimizer_state = None
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            model_state = sharding.gather_state(self.model, self.model.state_dict())
            optimizer_state = sharding.gather_optimizer_state(
                self.model, self.optimizer, self.optimizer.state_dict())
        path = self.ckpt.save(
            self.state,
            self.epoch if resume_epoch is None else resume_epoch,
            config=self.cfg,
            vocab_fingerprint=self.vocab.fingerprint() if self.vocab else None,
            metric=metric, model_state=model_state, optimizer_state=optimizer_state,
        )
        self._barrier()
        return path
