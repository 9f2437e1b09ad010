"""Rehearsals on the CPU: both drivers end to end at tiny widths (the port's
plain versions), every per-layer reader over their records, the result
line, and ``run.py``'s refusals without a card or without the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, load, tiny_config, tiny_mix
from portbench import readers, run, trace
from portbench.drivers import recognize_calls, train_steps

BENCH = load("..", "BENCHMARK.json")
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def fake_trace(record, names) -> trace.Trace:
    """A trace as ``trace.reduce`` makes it, with each named kernel busy."""
    return trace.Trace(window_s=2.0, busy_s=0.5, device_s={n: 0.05 for n in names},
                       gaps={"aten::copy_": 1.0, "none": 0.5})


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """One CPU run of each cell's driver at tiny widths, by cell name."""
    import time

    from conftest import Ctx

    out = {}
    for name, cell in CELLS.items():
        mix = tiny_mix(cell["traffic"])
        ctx = Ctx(tiny_config(cell["config"]), mix, {}, 2**31 + 3,
                  tmp_path_factory.mktemp(name.replace(".", "_")), 0.5)
        ctx.t_start = time.perf_counter()
        driver = train_steps if mix["driver"] == "train_steps" else recognize_calls
        out[name] = driver.run(ctx)
    return out


def test_drivers_report_their_end_to_end_metrics(records):
    for name, rec in records.items():
        for m in BENCH["end_to_end"]:
            if run.applies(m, name):
                assert rec["e2e"][run.e2e_quantity(m["name"])] > 0, (name, m["name"])
        assert rec["attempted"] > 0 and rec["failed"] == 0
        assert set(rec["checks"]) and all(c["limit"] is None for c in rec["checks"].values())
        assert rec["correct"] is False  # no limits given here


def test_every_reader_reads_its_cells(records, recorded_spans, monkeypatch):
    """Each cell's readers over its record, a trace and the program's spans
    of a CPU profiler run of the cell's configuration."""
    from asr_chinese_e2e_tpu_torch.utils import debug

    for name, rec in records.items():
        monkeypatch.setattr(debug, "spans", lambda name=name: list(recorded_spans[name]))
        rec = dict(rec)
        layers = int(rec["config"]["model"]["num_encoder_layers"])
        if rec["kind"] == "train":
            rec["traced_steps"] = rec["steps"][:2]
            rec["traced_launches"] = {"K1": 2 * layers, "K2": 2 * layers, "K3": 2, "K4": 2}
            rec["trace"] = fake_trace(rec, ["attention_fwd_mma_kernel", "ctc_grad_rows_kernel"])
        else:
            rec["traced_calls"] = rec["calls"][:1]
            rec["trace"] = fake_trace(rec, ["fbank_mma_kernel"])
        line = run.result_line(BENCH, name, rec, True, "cpu rehearsal")
        want = {m["name"] for m in BENCH["per_layer"] if run.applies(m, name)}
        assert set(line["metrics"]) == want, name
        for m in line["metrics"].values():
            assert m["value"] > 0
        assert line["device"]["busy_s"] == 0.5 and line["device"]["window_s"] == 2.0
        assert line["breakdown"]["idle_gaps"][0] == ["aten::copy_", 1.0]
        assert list(line)[-1] == "checks"


def test_rooflines_read_nothing_when_the_counters_disagree(records):
    rec = dict(next(r for r in records.values() if r["kind"] == "train"))
    rec["traced_steps"] = rec["steps"][:2]
    rec["traced_launches"] = {"K1": 1, "K2": 1, "K3": 1, "K4": 1}
    rec["trace"] = fake_trace(rec, ["attention_fwd_mma_kernel"])
    assert readers.attention_roofline(rec) is None and readers.ctc_roofline(rec) is None


def test_result_line_of_an_untraced_run(records):
    name = "offline.ref-transformer.beam-fill"
    line = run.result_line(BENCH, name, records[name], False, "cpu rehearsal")
    assert set(line["metrics"]) == {"decode_audio_s_per_s", "setup_s"}
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert line["device"]["platform"] == "gpu"
    json.dumps(line)


def test_trace_reduction_unions_intervals_and_names_gaps():
    class E:
        def __init__(self, name, dev, start, dur):
            self.n, self.d, self.s, self.u = name, dev, start, dur

        def name(self):
            return self.n

        def device_type(self):
            return "DeviceType.CUDA" if self.d else "DeviceType.CPU"

        def start_ns(self):
            return self.s

        def duration_ns(self):
            return self.u

    ev = [E("spin_kernel", True, 0, 50), E("k1", True, 100, 100), E("k2", True, 150, 100),
          E("aten::mm", False, 240, 100), E("k1", True, 300, 50)]
    t = trace.reduce(ev, 100, 400)
    assert t.window_s == 300e-9 and t.busy_s == pytest.approx(200e-9)
    assert t.device_s == pytest.approx({"k1": 150e-9, "k2": 100e-9})
    assert t.gaps == pytest.approx({"aten::mm": 50e-9, "none": 50e-9})


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_refuses_without_a_card():
    out = _run_py(ROOT, "--workload", "train.ref-transformer.aishell-fill", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA is not available" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, "--workload", "train.ref-transformer.aishell-fill", "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
