"""The verdict of a run: each compared number against its limit from
``portbench/limits/<cell>.json``. A number passes when it is finite and at
most its limit; a number with no limit fails. A number that the cell's
limits mark ``"compared": false`` (with the readings that show why) is
left out of the verdict and of the result."""

from __future__ import annotations

import math


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over ``numbers``."""
    checks, ok = {}, True
    for name, value in numbers.items():
        if limits.get(name, {}).get("compared") is False:
            continue
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not math.isfinite(value) or value > limit:
            ok = False
    return ok and bool(numbers), checks


def relative_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gap(program: dict, reference: dict, counted=None) -> tuple:
    """(worst leaf, its gap) of two {leaf: norm} maps: |program - reference|
    over the larger of the reference's norm of that leaf and of the median
    leaf, over the ``counted`` leaves (all by default)."""
    names = sorted(reference if counted is None else counted)
    ref = sorted(reference[n] for n in names)
    median = ref[len(ref) // 2]
    worst, gap = None, -1.0
    for n in names:
        g = abs(program[n] - reference[n]) / max(reference[n], median, 1e-30)
        if g > gap:
            worst, gap = n, g
    return worst, gap
