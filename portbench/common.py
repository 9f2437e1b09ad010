"""Small helpers shared by the harness's modules."""

from __future__ import annotations

import sys

import torch


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free_cuda(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def bucket_of(n_samples: int, boundaries) -> int:
    """The smallest boundary that holds ``n_samples`` (the last one caps)."""
    for b in boundaries:
        if n_samples <= b:
            return b
    return boundaries[-1]


def decode_boundaries(mix: dict) -> list:
    """The sample boundaries ``recognize`` pads a clip to: its bucket
    seconds, capped by ``max_seconds`` (``recognize.batched``)."""
    sr = 16000
    top = int(mix["recognize"]["max_seconds"] * sr)
    out = sorted({min(int(s * sr), top) for s in mix["pad_seconds"]})
    if out[-1] < top:
        out.append(top)
    return out


def spread_line(name: str, values) -> str:
    """One stderr line of a window's per-unit times: count, median, quartiles,
    the 95th percentile and the largest, in ms."""
    import numpy as np

    v = np.asarray(values, dtype=np.float64) * 1e3
    if v.size == 0:
        return f"{name}: none"
    q1, q2, q3, p95 = np.percentile(v, [25, 50, 75, 95])
    return (f"{name}: n={v.size} median={q2:.3f} q1={q1:.3f} q3={q3:.3f} p95={p95:.3f} "
            f"max={v.max():.3f} ms")
