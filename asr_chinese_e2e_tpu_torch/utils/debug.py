"""Debug and tracing helpers (``asr_chinese_e2e_tpu/utils/debug.py``) on
``torch.profiler`` and autograd's anomaly mode.

- ``profile_trace``: a ``torch.profiler`` trace of any code region, CPU
  and (when there is a card) CUDA activities, written as a Chrome trace
  under ``log_dir``; the trainer opens one over ``[profile_from_step,
  profile_from_step + profile_steps)``;
- ``debug_mode``: autograd's anomaly mode (a NaN made in a backward
  raises, naming the operation);
- ``annotate``: the port's span recorder (below).

**Spans.** ``with annotate(name):`` marks a stretch of host work. A span is
on exactly while a profiler is active in the calling thread (a
``torch.profiler.profile``, ``profile_trace`` or
``torch.autograd.profiler.emit_nvtx``, which turns the spans into NVTX
ranges). Off, it costs one check of that state: no profiler range, no
allocation. On, it opens a profiler range, so the profiler's trace shows
it (a ``RecordFunction`` of the operators' kind, ``cpu_op``: a user
annotation would also put a range on the card's timeline in a CUDA trace,
covering the kernels launched inside it, and so read as device work), and
keeps one record in memory: its name, start and end
on ``time.time_ns()`` (the profiler's clock: the ends lie inside the
range's own event), the span open around it in this thread (its parent)
and the request it serves (a ``recognize`` call's number, a train step's
number; a span given none inherits its parent's). ``spans()`` reads the
records kept since the last ``clear_spans()`` as ``Span`` objects.

The port's spans: ``train_step`` with ``train.features``,
``train.forward``, ``train.loss``, ``train.backward``,
``train.optimizer`` and ``train.metric_sums``
(``train/train_step.py``); ``recognize`` with ``recognize.next_batch``,
``recognize.dispatch`` (``recognize.encode``, ``recognize.search``),
``recognize.drain`` and ``recognize.consume`` (``recognize.py``);
``beam.step`` (``decode/beam.py``); ``rescore.ctc_log_probs``,
``rescore.prefix_beam``, ``rescore.nbest_to_host`` and
``rescore.forward``; ``encoder.frontend`` around the encoder's frontend and,
with relative positions, ``encoder.relpos`` around the relative table,
its dropout and every block's projection of it
(``models/transformer.py``). The kernels count their own launches
(``ops/fused_attention.py``: ``fused_attention_general.launches`` for K1,
``relpos_attention_kernel.launches`` and
``relpos_attention_backward_kernel.launches`` for the rel-pos K11/K12). A host read of a card tensor, or a wait for the
card, is a span ``sync.<site>`` around the reading call itself, so a
sync's count and its wait are read from the same records.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled


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


class Span:
    """One recorded span, as ``spans()`` returns it."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request")

    def __init__(self, name: str, start_ns: int, end_ns: int, parent: "Span | None", request):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.request = parent, request

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent.name if self.parent else None!r}, "
                f"request={self.request!r})")


# each closed span as a plain tuple (name, start_ns, end_ns, index, parent's
# index, request): tuples of numbers and strings leave the garbage
# collector's lists, so the records add nothing to its full collections
_SPANS: list = []
_INDEX = itertools.count()  # the order the spans open in
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


class _Recording:
    """An open span: the profiler's range and what its record will hold."""

    __slots__ = ("name", "request", "index", "parent", "start_ns", "_range")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        parent = stack[-1] if stack else None
        if self.request is None and parent is not None:
            self.request = parent.request
        self.parent = parent.index if parent is not None else None
        self.index = next(_INDEX)
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        _OPEN.stack.pop()
        self._range.__exit__(*exc)
        _SPANS.append((self.name, self.start_ns, end_ns, self.index, self.parent, self.request))
        return False


class _Off:
    """The span when no profiler is active: enters and leaves, nothing
    else."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def annotate(name: str, request=None):
    """A span named ``name`` around the enclosed host work (see the module's
    docstring); ``request`` names the request it serves."""
    if _profiler_enabled():
        return _Recording(name, request)
    return _OFF


def spans() -> list:
    """The spans closed since the last ``clear_spans()``, in the order they
    opened, each linked to its parent (None for a root, or a parent still
    open)."""
    out, by_index = [], {}
    for name, start_ns, end_ns, index, parent, request in sorted(_SPANS, key=lambda r: r[3]):
        span = by_index[index] = Span(name, start_ns, end_ns, by_index.get(parent), request)
        out.append(span)
    return out


def clear_spans() -> None:
    _SPANS.clear()
