"""Debug and tracing helpers (``asr_chinese_e2e_tpu/utils/debug.py``) on
``torch.profiler``, autograd's anomaly mode and NVTX.

- ``profile_trace``: a ``torch.profiler`` trace of any code region, CPU
  and (when there is a card) CUDA activities, written as a Chrome trace
  under ``log_dir``; the trainer opens one over ``[profile_from_step,
  profile_from_step + profile_steps)``;
- ``debug_mode``: autograd's anomaly mode (a NaN made in a backward
  raises, naming the operation);
- ``annotate``: a named range in the profiler's trace, and an NVTX range
  on the card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


WARMUP_LAUNCHES = 32


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed region; writes ``log_dir/trace_<ns>.json``
    (Chrome trace format) when it closes.

    The profiler warms up before the region: tracing is on and
    ``WARMUP_LAUNCHES`` small launches are made and waited for (their
    records stay in the trace, before the region's). On an H100, in a
    process that had traced before, the card's records of the first ten or
    so launches after a start were missing from the trace (their runtime
    calls were there). One warm-up launch, its records dropped at a
    schedule step, did not always take that loss (the region's first launch
    was lost once in two runs), so the warm-up makes more launches than the
    loss takes, and no schedule step starts the region anew."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    if cuda:  # the warm-up
        x = torch.ones(1, device="cuda")
        for _ in range(WARMUP_LAUNCHES):
            x.add_(1)
        torch.cuda.synchronize()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def debug_mode(nans: bool = True, disable_jit: bool = False):
    """Debug checks for the enclosed region. ``nans`` turns on
    ``torch.autograd.set_detect_anomaly(True)``: a backward that makes a
    NaN raises, with the forward operation's traceback. ``disable_jit`` is
    accepted for the JAX package's signature and does nothing: the port
    runs eagerly, with no jit to disable."""
    with contextlib.ExitStack() as stack:
        if nans:
            stack.enter_context(torch.autograd.set_detect_anomaly(True))
        yield


@contextlib.contextmanager
def annotate(name: str):
    """A named range: a ``record_function`` span in the profiler's trace,
    and an NVTX range when there is a card."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
