"""Checkpoint / resume with best-pointer tracking
(``asr_chinese_e2e_tpu/train/checkpoint.py``, with ``torch.save`` in place
of orbax).

Layout under ``directory``:

    e{E}_s{S}/state.pt   {model, optimizer, step, epoch, metric_sums}
    e{E}_s{S}/meta.json  {epoch, step, vocab_fingerprint, config, metric}
    index.json           {latest, best, best_metric, all}

``reference='-loss'`` picks the best checkpoint ('-' = lower is better).
Saves are synchronous and crash-consistent: ``state.pt`` is written to a
temporary name and renamed, and ``index.json`` (also renamed into place)
moves its pointers only after the checkpoint is complete, so ``latest``
never points at a torn checkpoint. ``max_to_keep`` bounds the number
kept (latest and best are never removed); a checkpoint past it is deleted
only after the index that drops it is published, so no published pointer
names a deleted checkpoint. When ``export_dir`` is given, the best
checkpoint's weights are also written as
``export_dir/torch_checkpoints/best.pt``, the file
``utils/experiment.py::load_experiment`` serves from.

Across processes (``writer``): every rank keeps the index in step, only
the writer (rank 0) writes files, and every rank restores. A sharded run
hands ``save`` and ``restore`` its whole-tensor states and its cut
(``parallel/sharding.py::gather_state`` / ``slice_state``), so the files
are those of an unsharded run.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

from ..core.config import Config
from ..utils.experiment import save_torch_checkpoint


def _metric_better(reference: str, new: float, old: Optional[float]) -> bool:
    if old is None:
        return True
    return new < old if reference.startswith("-") else new > old


def _atomic_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, default=str)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, reference: str = "-loss",
                 max_to_keep: int = 5, export_dir: Optional[str] = None,
                 writer: bool = True):
        self.directory = os.path.abspath(directory)
        self.writer = writer
        os.makedirs(self.directory, exist_ok=True)
        self.reference = reference
        self.max_to_keep = max_to_keep
        self.export_dir = export_dir
        self._index_path = os.path.join(self.directory, "index.json")
        self._index = self._load_index()

    def _load_index(self) -> dict:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {"latest": None, "best": None, "best_metric": None, "all": []}

    def _step_dir(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, state, epoch: int, config: Config | None = None,
             vocab_fingerprint: str | None = None,
             metric: float | None = None, model_state=None,
             optimizer_state=None) -> str:
        """Write checkpoint ``e{epoch}_s{step}`` of ``state`` (a
        ``train_step.TrainState``; ``model_state`` / ``optimizer_state``
        in place of its own state dicts), then publish it in the index."""
        step = state.step
        name = f"e{epoch}_s{step}"
        path = self._step_dir(name)
        if model_state is None:
            model_state = state.model.state_dict()
        if optimizer_state is None:
            optimizer_state = state.optimizer.state_dict()
        if not self.writer:
            self._publish(name, metric)
            return path
        os.makedirs(path, exist_ok=True)
        blob = {
            "model": model_state,
            "optimizer": optimizer_state,
            "step": step,
            "epoch": int(epoch),
            "metric_sums": {k: v.detach().cpu() for k, v in state.metric_sums.items()},
        }
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        _atomic_json(os.path.join(path, "meta.json"), {
            "epoch": epoch,
            "step": step,
            "vocab_fingerprint": vocab_fingerprint,
            "config": config.to_dict() if config is not None else None,
            "metric": metric,
        })
        best, victims = self._publish(name, metric)
        if best and self.export_dir is not None:
            save_torch_checkpoint(self.export_dir, model_state, vocab_fingerprint, "best")
        _atomic_json(self._index_path, self._index)
        # deleted only once no published pointer names them: a kill in
        # between leaves a stale directory, never a dangling pointer
        for victim in victims:
            shutil.rmtree(self._step_dir(victim), ignore_errors=True)
        return path

    def _publish(self, name: str, metric) -> tuple:
        """Move the index's pointers to checkpoint ``name`` (in memory);
        returns (whether it is the new best, the names it retires)."""
        self._index["latest"] = name
        if name not in self._index["all"]:
            self._index["all"].append(name)
        best = metric is not None and _metric_better(
            self.reference, metric, self._index["best_metric"])
        if best:
            self._index["best"] = name
            self._index["best_metric"] = metric
        return best, self._retire()

    def _retire(self) -> list:
        """Drop the oldest checkpoints past ``max_to_keep`` from the index
        (never latest or best); returns their names."""
        keep = {n for n in (self._index["latest"], self._index["best"]) if n}
        extra = [n for n in self._index["all"] if n not in keep]
        victims = []
        while len(extra) + len(keep) > self.max_to_keep and extra:
            victims.append(extra.pop(0))
            self._index["all"].remove(victims[-1])
        return victims

    @property
    def latest_name(self) -> Optional[str]:
        return self._index["latest"]

    @property
    def best_name(self) -> Optional[str]:
        return self._index["best"]

    def wait(self) -> None:
        """Returns at once: ``save`` writes and publishes before it returns,
        so no save is ever in flight (the JAX package's manager commits
        asynchronously and blocks here)."""

    def restore(self, which: str, state, cut=None) -> dict:
        """Load 'latest' | 'best' | an explicit 'e{E}_s{S}' into ``state``
        (model, optimizer, step, metric sums, in place); returns the meta
        dict. ``cut(model_state, optimizer_state)`` -> the pair this
        process loads (a sharded run's chunks of the whole tensors)."""
        if which in ("latest", "best"):
            self._index = self._load_index()
            name = self._index.get(which)
        else:
            name = which
        if name is None or not os.path.exists(self._step_dir(name)):
            raise FileNotFoundError(f"no '{which}' checkpoint in {self.directory}")
        path = self._step_dir(name)
        dev = next(state.model.parameters()).device
        blob = torch.load(os.path.join(path, "state.pt"), map_location=dev,
                          weights_only=True)
        model_state, optimizer_state = blob["model"], blob["optimizer"]
        if cut is not None:
            model_state, optimizer_state = cut(model_state, optimizer_state)
        state.model.load_state_dict(model_state)
        state.optimizer.load_state_dict(optimizer_state)
        state.step = int(blob["step"])
        for k, v in blob["metric_sums"].items():
            state.metric_sums[k] = v.to(dev)
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
