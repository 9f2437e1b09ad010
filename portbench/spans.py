"""What the per-layer metrics of source ``program_span`` read: the spans the
program records itself (``asr_chinese_e2e_tpu_torch/utils/debug.py``).

The program records a span only while a profiler is active, and the traced
segment of a ``--trace 1`` run is the run's only profiled stretch, so when
the metrics are read the recorder holds that segment's spans and nothing
else. Each function returns None where there is nothing to read: a run
without a traced segment, or a program that records no spans (it lacks the
recorder, or the span named); the harness then leaves the metric out.

A span has ``name``, ``start_ns``, ``end_ns`` (the host's clock, the one
the profiler's events are on), ``parent`` (the span open around it, or
None) and ``request``. Host syncs are the spans named ``sync.<site>``."""

from __future__ import annotations

SYNC = "sync."


def recorded(record) -> list | None:
    """The program's spans of the run's traced segment, or None."""
    if record.get("trace") is None:
        return None
    try:
        from asr_chinese_e2e_tpu_torch.utils import debug
    except ImportError:
        return None
    read = getattr(debug, "spans", None)
    return (read() or None) if read is not None else None


def _ms(ns: float) -> float:
    return ns / 1e6


def under(spans: list, root: str) -> list:
    """[(root span, [its descendants])] for every span named ``root``."""
    kids = {id(s): [] for s in spans if s.name == root}
    for s in spans:
        p = s.parent
        while p is not None:
            if id(p) in kids:
                kids[id(p)].append(s)
                break
            p = p.parent
    return [(s, kids[id(s)]) for s in spans if s.name == root]


def _syncs(spans: list) -> list:
    return [s for s in spans if s.name.startswith(SYNC)]


def _per_root(record, root: str, of) -> float | None:
    """The mean over the spans named ``root`` of ``of(root span, its
    descendants)``."""
    spans = recorded(record)
    if not spans:
        return None
    groups = under(spans, root)
    if not groups:
        return None
    return sum(of(r, kids) for r, kids in groups) / len(groups)


def step_dispatch_ms(record) -> float | None:
    """A ``train_step`` span less its host syncs: the host's own work a
    step, ms."""
    return _per_root(record, "train_step", lambda r, kids: _ms(
        r.end_ns - r.start_ns - sum(s.end_ns - s.start_ns for s in _syncs(kids))))


def sync_wait_ms(record) -> float | None:
    """The host's time in syncs a ``train_step`` span, ms."""
    return _per_root(record, "train_step", lambda r, kids: _ms(
        sum(s.end_ns - s.start_ns for s in _syncs(kids))))


def syncs_per(record, root: str) -> float | None:
    """Host syncs a ``root`` span (a count)."""
    return _per_root(record, root, lambda r, kids: len(_syncs(kids)))


def mean_ms(record, name: str) -> float | None:
    """The mean span named ``name``, ms."""
    spans = recorded(record)
    found = [s for s in spans or () if s.name == name]
    if not found:
        return None
    return _ms(sum(s.end_ns - s.start_ns for s in found) / len(found))


def total_ms_per(record, name: str, unit: str) -> float | None:
    """The spans named ``name`` summed, over the spans named ``unit``,
    ms."""
    spans = recorded(record)
    n = sum(1 for s in spans or () if s.name == unit)
    if not n:
        return None
    return _ms(sum(s.end_ns - s.start_ns for s in spans if s.name == name) / n)


def syncs_per_batch(record) -> float | None:
    """Host syncs inside the traced ``recognize`` calls, their drains'
    included, over their batches (``recognize.dispatch`` spans): a
    count."""
    spans = recorded(record)
    batches = sum(1 for s in spans or () if s.name == "recognize.dispatch")
    if not batches:
        return None
    return sum(len(_syncs(kids)) for _, kids in under(spans, "recognize")) / batches
