"""What the per-layer metrics of the rel-pos conformer's cell read from a
run's record (``drivers/train_steps_conformer.py``), beside ``readers.py``
and ``spans.py``, whose readers it shares. Each returns None where the
record holds nothing to read (a program without K11/K12's counters, or a
run without a traced segment); the harness then leaves the metric out."""

from __future__ import annotations

import re

from .counts import bounds, conformer
from .counts.peaks import peak_flops
from .readers import CTC_KERNELS

# K11 and K12 in the profiler's trace: the tensor-core attention kernels'
# instantiations whose last template argument, RELPOS, is true
RELPOS_KERNEL = re.compile(r"attention_(fwd|bwd_dq|bwd_dkdv)_mma_kernel<\d+, (true|false), true>")


def _conformer_train(record) -> bool:
    return record.get("kind") == "train_conformer"


def train_mfu(record) -> float | None:
    """The frozen ``counts/conformer.py`` count of each window step at its
    padded shapes over the window, of the dense bf16 peak, %."""
    if not _conformer_train(record) or not record.get("steps"):
        return None
    cfg, feat = record["config"]["model"], record["config"]["features"]
    v = record["config"]["vocab_size"]
    total = sum(conformer.analytic_train_flops(cfg, feat, v, s["batch"], s["n_samples"],
                                               s["label_len"]) for s in record["steps"])
    return 100.0 * total / record["window_s"] / peak_flops(cfg["dtype"])


def device_ms_per_step(record) -> float | None:
    """The device's busy time in the traced steps over their count, ms."""
    if not _conformer_train(record) or record.get("trace") is None:
        return None
    n = len(record.get("traced_steps") or [])
    return record["trace"].busy_s / n * 1e3 if n else None


def relpos_roofline(record) -> float | None:
    """K11 + K12 of the traced steps: their least time (one of each a block
    a step, at the step's padded shapes) over their device time, %. None
    unless the launch counters saw exactly those launches."""
    if not _conformer_train(record) or record.get("trace") is None:
        return None
    steps = record.get("traced_steps") or []
    cfg, feat = record["config"]["model"], record["config"]["features"]
    layers = int(cfg["num_encoder_layers"])
    n = layers * len(steps)
    launched = record.get("traced_launches", {})
    if not steps or launched.get("K11") != n or launched.get("K12") != n:
        return None
    h, d = cfg["num_heads"], cfg["head_dim"]
    least = 0.0
    for s in steps:
        t = conformer.encoder_frames(feat, s["n_samples"])
        least += layers * (conformer.relpos_fwd_bound(s["batch"], h, t, d)["bound_ms"]
                           + conformer.relpos_bwd_bound(s["batch"], h, t, d)["bound_ms"])
    spent = sum(sec for name, sec in record["trace"].device_s.items()
                if RELPOS_KERNEL.search(name)) * 1e3
    return 100.0 * least / spent if spent > 0 else None


def ctc_roofline(record) -> float | None:
    """K3 + K4 of the traced steps, as ``readers.ctc_roofline`` reads them,
    at the frames the conv2d frontend leaves: one of each a step over the
    step's (B, T', V) bf16 logits and S = 2 L + 1 extended labels. None
    unless the launch counters saw exactly those launches."""
    if not _conformer_train(record) or record.get("trace") is None:
        return None
    steps = record.get("traced_steps") or []
    n = len(steps)
    launched = record.get("traced_launches", {})
    if not steps or launched.get("K3") != n or launched.get("K4") != n:
        return None
    feat, v = record["config"]["features"], record["config"]["vocab_size"]
    least = 0.0
    for s in steps:
        t = conformer.encoder_frames(feat, s["n_samples"])
        sx = 2 * s["label_len"] + 1
        least += (bounds.ctc_alpha_bound(s["batch"], t, v, sx)["bound_ms"]
                  + bounds.ctc_beta_bound(s["batch"], t, v, sx)["bound_ms"])
    spent = record["trace"].device_time(CTC_KERNELS) * 1e3
    return 100.0 * least / spent if spent > 0 else None
