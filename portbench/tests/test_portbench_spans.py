"""The readers of the program's spans (``portbench/spans.py`` and the
``program_span`` metric files) over a recorder filled on the CPU: a
profiled train step of each training cell's configuration and profiled
``recognize`` calls of each decode cell's, at tiny widths. Every value is
finite, every count a whole number, the step's host work and its syncs add
up to the step, and the rescore split lies inside the search; a program
without the recorder, or a run with nothing traced, gives nothing."""

from __future__ import annotations

import math
import os

import pytest

from conftest import ROOT, load
from portbench import run, spans

from asr_chinese_e2e_tpu_torch.utils import debug

BENCH = load("..", "BENCHMARK.json")
# the metrics that read the program's own spans
NEW = [m for m in BENCH["per_layer"] if m["name"].split(".")[0] in (
    "step_dispatch_ms", "sync_wait_ms", "syncs_per_step", "beam_step_ms", "syncs_per_batch",
    "batch_wait_ms", "prefix_beam_ms", "nbest_to_host_ms", "rescore_forward_ms",
    "syncs_per_request")]
def _read(metric, spans_of_cell, monkeypatch):
    monkeypatch.setattr(debug, "spans", lambda: list(spans_of_cell))
    record = {"trace": object()}
    reader = run.load_by_path(os.path.join(ROOT, "portbench", "metrics", metric + ".py"),
                              "portbench_metric_" + metric.replace(".", "_"))
    return reader.value(record)


def test_the_thirteen_metrics_are_there():
    assert len(NEW) == 13
    for m in NEW:
        assert m["better"] == "lower" and len(m["workloads"]) == 1


@pytest.mark.parametrize("metric", [m["name"] for m in NEW])
def test_each_reader_reads_its_cell(metric, recorded_spans, monkeypatch):
    m = next(x for x in NEW if x["name"] == metric)
    value = _read(metric, recorded_spans[m["workloads"][0]], monkeypatch)
    assert value is not None and math.isfinite(value) and value >= 0, value
    if metric.startswith("syncs_per_"):
        assert value == int(value) and value > 0
    else:
        assert value > 0


def test_a_steps_host_work_and_its_syncs_make_the_step(recorded_spans, monkeypatch):
    for cell, suffix in (("train.ref-transformer.aishell-fill", "train"),
                         ("train.large-transformer.aishell", "train_b64")):
        got = {k: _read(f"{k}.{suffix}", recorded_spans[cell], monkeypatch)
               for k in ("step_dispatch_ms", "sync_wait_ms")}
        steps = [s for s in recorded_spans[cell] if s.name == "train_step"]
        mean = sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6
        assert got["step_dispatch_ms"] + got["sync_wait_ms"] == pytest.approx(mean, rel=1e-9)


def test_the_rescore_split_lies_inside_the_search(recorded_spans, monkeypatch):
    cell = recorded_spans["online.large-transformer.rescore"]
    parts = sum(_read(f"{k}.online", cell, monkeypatch)
                for k in ("prefix_beam_ms", "nbest_to_host_ms", "rescore_forward_ms"))
    search = [s for s in cell if s.name == "recognize.search"]
    assert len(search) == 3
    assert parts <= sum(s.end_ns - s.start_ns for s in search) / len(search) / 1e6


def test_nothing_to_read_gives_nothing(recorded_spans, monkeypatch):
    train = recorded_spans["train.large-transformer.aishell"]
    assert spans.step_dispatch_ms({"trace": None}) is None
    monkeypatch.setattr(debug, "spans", lambda: [])
    assert spans.step_dispatch_ms({"trace": object()}) is None
    # a program without the recorder (the spans' reader absent)
    monkeypatch.delattr(debug, "spans")
    for m in NEW:
        reader = run.load_by_path(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"),
                                  "portbench_metric_" + m["name"].replace(".", "_"))
        assert reader.value({"trace": object()}) is None
    # a recorder holding only another kind of unit
    monkeypatch.undo()
    monkeypatch.setattr(debug, "spans", lambda: list(train))
    assert spans.mean_ms({"trace": object()}, "beam.step") is None
    assert spans.syncs_per_batch({"trace": object()}) is None
