"""The port's debug and tracing helpers (``utils/debug.py``) and the
trainer's trace window, on the CPU: ``profile_from_step`` /
``profile_steps`` write one Chrome trace under ``exp_dir/trace/`` that holds
exactly the window's train steps, each in an ``annotate("train_step")``
range; ``annotate`` ranges appear in a ``profile_trace``; ``debug_mode``
raises on a NaN made in a backward, and without it the NaN passes."""

import json
import os

import pytest
import torch

from asr_chinese_e2e_tpu_torch.main import train
from asr_chinese_e2e_tpu_torch.utils.debug import annotate, debug_mode, profile_trace
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.test_torch_trainer import CORPUS_KW, _run_kwargs

torch.set_num_threads(2)


def _events(log_dir):
    files = sorted(os.listdir(log_dir))
    return files, [e for f in files
                   for e in json.load(open(os.path.join(log_dir, f)))["traceEvents"]]


def _named(events, name):
    return [e for e in events if e.get("name") == name and e.get("ph") == "X"]


def test_trace_window_holds_its_steps_only(tmp_path):
    corpus = make_synth_corpus(str(tmp_path / "corpus"), **CORPUS_KW)
    trainer = train(**_run_kwargs(corpus, str(tmp_path / "exp"), num_epoch=1,
                                  profile_from_step=1, profile_steps=2))
    assert trainer.state.step == 4  # 16 utterances, batch 4
    files, events = _events(os.path.join(trainer.exp_dir, "trace"))
    assert len(files) == 1 and files[0].endswith(".json")
    steps = _named(events, "train_step")
    assert len(steps) == 2
    # one optimizer update inside each range, and none outside them
    updates = [e for e in events if e.get("ph") == "X"
               and e.get("name", "").startswith("Optimizer.step")]
    assert len(updates) == 2
    for u in updates:
        assert any(s["ts"] <= u["ts"] and u["ts"] + u["dur"] <= s["ts"] + s["dur"]
                   for s in steps)


def test_trace_window_closes_at_the_epoch_end(tmp_path):
    corpus = make_synth_corpus(str(tmp_path / "corpus"), **CORPUS_KW)
    trainer = train(**_run_kwargs(corpus, str(tmp_path / "exp"), num_epoch=1,
                                  profile_from_step=3, profile_steps=5))
    files, events = _events(os.path.join(trainer.exp_dir, "trace"))
    assert len(files) == 1 and len(_named(events, "train_step")) == 1


def test_annotate_ranges_appear_in_a_trace(tmp_path):
    x = torch.ones(8)
    with profile_trace(str(tmp_path)):
        with annotate("outer_range"):
            with annotate("inner_range"):
                x = x * 2
    files, events = _events(str(tmp_path))
    assert len(files) == 1
    outer, inner = _named(events, "outer_range"), _named(events, "inner_range")
    assert len(outer) == len(inner) == 1
    assert outer[0]["ts"] <= inner[0]["ts"]
    assert inner[0]["ts"] + inner[0]["dur"] <= outer[0]["ts"] + outer[0]["dur"]


def _nan_in_backward():
    x = torch.zeros(3, requires_grad=True)
    # sqrt(0) = 0 forward; its backward makes 0.5 / 0 = inf, times 0: NaN
    (x.sqrt() * 0.0).sum().backward()
    return x.grad


def test_debug_mode_raises_on_a_nan_made_in_a_backward():
    assert torch.isnan(_nan_in_backward()).all()
    with debug_mode(nans=True, disable_jit=True):
        with pytest.raises(RuntimeError, match="nan"):
            _nan_in_backward()
    with debug_mode(nans=False):
        assert torch.isnan(_nan_in_backward()).all()
    assert not torch.is_anomaly_enabled()
