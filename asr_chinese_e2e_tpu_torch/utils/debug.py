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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed region; writes ``log_dir/trace_<ns>.json``
    (Chrome trace format) when it closes.

    The profiler warms up before the region: tracing is on, one small
    launch is made and waited for, and what the warm-up records is dropped.
    On an H100, in a process that had traced before, the card's records of
    the first ten or so launches after a start were missing from the trace
    (their runtime calls were there); a launch waited for during the
    warm-up takes that loss, and the region's records are whole."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1 << 30))
    prof.start()  # the warm-up
    if cuda:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    prof.step()  # the region is recorded from here
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
