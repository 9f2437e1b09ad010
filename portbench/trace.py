"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over a
stretch of the cell's own work, read in memory (no trace file).

64 spin kernels run first inside the profiler, because a process's first
launches under a trace can go missing from it; the window starts after
them. What is kept of the trace, ``Trace``:

- ``window_s``: the traced window, host clock, after a sync at each end;
- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window;
- ``device_s``: device seconds by kernel name;
- ``gaps``: the idle stretches between device intervals, each named by the
  innermost host operation running at the gap's start."""

from __future__ import annotations

import dataclasses
import time

import torch

SPIN_KERNELS = 64
SPIN_NAME = "spin_kernel"
NAME_CHARS = 160


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_s: dict
    gaps: dict

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_time(self, names) -> float:
        """Device seconds of the kernels whose names contain one of
        ``names``."""
        return sum(s for k, s in self.device_s.items() if any(n in k for n in names))

    def breakdown(self) -> dict:
        """The ten device operations with the most time and the ten host
        operations with the most idle time, names cut to ``NAME_CHARS``."""
        top = lambda d: [[k[:NAME_CHARS], v]
                         for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.device_s), "idle_gaps": top(self.gaps)}


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def traced(fn) -> Trace:
    """Run ``fn()`` under the profiler and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.time_ns()
        fn()
        torch.cuda.synchronize()
        t1 = time.time_ns()
    return reduce(prof.profiler.kineto_results.events(), t0, t1)


def reduce(events, t0: int, t1: int) -> Trace:
    dev, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        end = start + dur
        if end <= t0 or start >= t1:
            continue
        if _is_device(e):
            if SPIN_NAME not in e.name():
                dev.append((max(start, t0), min(end, t1), e.name()))
        else:
            host.append((start, end, e.name()))
    dev.sort()
    device_s, busy, gaps_at = {}, 0, []
    cursor = t0
    for start, end, name in dev:
        device_s[name] = device_s.get(name, 0.0) + (end - start) / 1e9
        if start > cursor:
            gaps_at.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if t1 > cursor:
        gaps_at.append((cursor, t1))
    return Trace((t1 - t0) / 1e9, busy / 1e9, device_s, _name_gaps(gaps_at, host))


def _name_gaps(gaps_at, host) -> dict:
    """Idle seconds by the innermost host operation open at each gap's
    start ("none" where no operation is open)."""
    host.sort()
    out = {}
    j, open_ops = 0, []
    for start, end in gaps_at:
        while j < len(host) and host[j][0] <= start:
            open_ops.append(host[j])
            j += 1
        open_ops = [h for h in open_ops if h[1] > start]
        name = min(open_ops, key=lambda h: h[1] - h[0])[2] if open_ops else "none"
        out[name] = out.get(name, 0.0) + (end - start) / 1e9
    return out
