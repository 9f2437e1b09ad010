"""Metrics accumulation and scalar logging (a copy of the JAX package's
jax-free ``train/metrics.py``).

``MetricsAccumulator`` is the ``MetricsManager`` analogue
(``Trainer/metric_manager.py:6-86``): num_samples-weighted running means —
without the string round-trip anti-pattern (``metric_manager.py:84-86``,
SURVEY §5.5).

``ScalarWriter`` logs the reference's scalar set (``trainer11.py:58-62,
108-112``: lr, train/loss, train/cer, dev/*, test/*) plus throughput
(audio-seconds/s/chip — the BASELINE metric) to TensorBoard when available
and always to a JSONL file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsAccumulator:
    def __init__(self) -> None:
        self._sums: Dict[str, float] = {}
        self._weights: Dict[str, float] = {}

    def update(self, metrics: Dict[str, float], num_samples: float = 1.0) -> None:
        for k, v in metrics.items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v) * num_samples
            self._weights[k] = self._weights.get(k, 0.0) + num_samples

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / self._weights[k] for k in self._sums}

    def reset(self) -> None:
        self._sums.clear()
        self._weights.clear()

    def __len__(self) -> int:
        return len(self._sums)


class ScalarWriter:
    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            pass

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullScalarWriter:
    """No-op writer for non-zero processes: on a shared filesystem only
    process 0 writes scalars.jsonl / TB events (one writer per artifact,
    same policy as checkpoint index/meta)."""

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        pass

    def close(self) -> None:
        pass


class ThroughputMeter:
    """audio-seconds/s/chip — the north-star throughput metric."""

    def __init__(self, n_chips: int = 1) -> None:
        self.n_chips = n_chips
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self._audio_seconds = 0.0
        self._steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def step(self, audio_seconds: float) -> None:
        if self._t0 is None:
            self.start()
        self._audio_seconds += audio_seconds
        self._steps += 1

    @property
    def audio_seconds_per_sec_per_chip(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        wall = time.perf_counter() - self._t0
        return self._audio_seconds / wall / self.n_chips

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        return self._steps / (time.perf_counter() - self._t0)
