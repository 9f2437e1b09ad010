"""The port's training bench (``asr_chinese_e2e_tpu_torch/bench.py``) against
the JAX package's root ``bench.py``, on the CPU at tiny widths.

- ``analytic_train_flops`` equals the JAX bench's count exactly on the
  flagship and on toy configurations (with and without a CTC head).
- The host batch the port's ``main`` steps on equals, array for array and
  dtype for dtype, the batch the JAX ``bench.main`` hands its step (caught
  by replacing the JAX package's ``make_step_fns``, which ``bench.main``
  imports at call time).
- ``main`` prints one last JSON line with the JAX bench's keys, its metric
  name and ``card``; its ``flops_per_step`` is JAX's; MFU is null off the
  card.
- ``steps_per_dispatch`` > 1 raises (ROADMAP item 9); asking for the card
  without one raises, from Python and from the command line.
- ``scaling_main`` at counts 1 and 2 on gloo ranks gives a finite table,
  efficiency 1.0 first.
- ``via_trainer_main`` steps ``len(loader)`` times an epoch, two epochs.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.models.transformer import default_config as jax_default_config
from asr_chinese_e2e_tpu_torch import bench
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.models.transformer import default_config

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=16, num_heads=2, head_dim=8, d_ff=32, num_encoder_layers=1,
            num_decoder_layers=1)
# the widths of tests/test_scaling_harness.py, on the CPU's plain versions
SMALL = dict(seconds=0.5, vocab_size=40, label_len=4, dtype="float32", attn_impl="xla",
             fbank_impl="xla", device="cpu", **TINY)
# the JAX bench's result keys (bench.py:379-388)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "steps_per_s", "flops_per_step", "mfu",
            "n_chips"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny models are many small operations: with every core's thread
    spinning on each, test files side by side starve one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _jax_flops(overrides, vocab, batch, seconds, label_len):
    cfg = jax_default_config().build(**{"ctc_weight": 0.3, "dtype": "bfloat16",
                                        "input_dim": 320, **overrides})
    return jax_bench.analytic_train_flops(cfg, JaxFeatureConfig(), vocab, batch,
                                          int(seconds * 16000), label_len)


@pytest.mark.parametrize("overrides, vocab, batch, seconds, label_len", [
    ({}, 4233, 64, 8.0, 20),
    (TINY, 40, 2, 0.5, 4),
    ({**TINY, "ctc_weight": 0.0, "num_encoder_layers": 3}, 97, 3, 1.3, 7),
], ids=["flagship", "toy", "toy_no_ctc"])
def test_flops_equal_the_jax_bench(overrides, vocab, batch, seconds, label_len):
    cfg = default_config().build(**{"ctc_weight": 0.3, "dtype": "bfloat16", "input_dim": 320,
                                    **overrides})
    ours = bench.analytic_train_flops(cfg, FeatureConfig(), vocab, batch,
                                      int(seconds * 16000), label_len)
    assert ours == _jax_flops(overrides, vocab, batch, seconds, label_len)


class _Stop(Exception):
    pass


def test_host_batch_equals_the_jax_bench_batch(monkeypatch):
    import asr_chinese_e2e_tpu.train.train_step as jax_train_step
    import asr_chinese_e2e_tpu_torch.bench as port_bench

    theirs, ours = {}, {}

    def jax_step_fns(model, tx, feat_cfg, tcfg):
        def init_fn(key, host_batch):
            theirs.update(host_batch)
            raise _Stop
        return init_fn, None, None

    def port_step_fns(model, optimizer, feat_cfg, tcfg):
        def train_step(state, *arrays):
            ours.update(zip(bench.BATCH_KEYS, (a.numpy() for a in arrays[:4])))
            raise _Stop
        return lambda: None, train_step, None

    monkeypatch.setattr(jax_train_step, "make_step_fns", jax_step_fns)
    monkeypatch.setattr(port_bench, "make_step_fns", port_step_fns)
    shape = dict(batch=8, seconds=2.0)
    with pytest.raises(_Stop):
        jax_bench.main(**shape, **TINY)
    with pytest.raises(_Stop):
        bench.main(device="cpu", **shape, **TINY)
    assert set(ours) == set(theirs) == set(bench.BATCH_KEYS)
    for k in bench.BATCH_KEYS:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["wave"].shape == (8, 32000) and ours["labels"].shape == (8, 20)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_main_prints_the_jax_line_on_the_cpu(capsys):
    bench.main(n_steps=2, batch=2, **SMALL)
    line = _last_json(capsys)
    assert set(line) == JAX_KEYS | {"card"}
    assert line["metric"] == "train_throughput_audio_seconds_per_sec_per_chip"
    assert line["unit"] == "audio-s/s/chip" and line["vs_baseline"] is None
    assert line["card"] == "cpu" and line["mfu"] is None and line["n_chips"] == 1
    assert np.isfinite(line["value"]) and line["value"] > 0
    assert line["value"] == pytest.approx(line["steps_per_s"] * 2 * 0.5)
    assert line["flops_per_step"] == _jax_flops(TINY, 40, 2, 0.5, 4)


@pytest.mark.parametrize("fn", ["main", "via_trainer_main"])
def test_steps_per_dispatch_raises(fn):
    with pytest.raises(ValueError, match="item 9"):
        getattr(bench, fn)(steps_per_dispatch=2, device="cpu")


def test_the_card_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the no-CUDA refusal")
    for fn in (bench.main, bench.via_trainer_main, bench.scaling_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    proc = subprocess.run([sys.executable, "-m", "asr_chinese_e2e_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert proc.stdout.strip() == ""


def test_scaling_main_on_gloo_ranks(capsys):
    result = bench.scaling_main(per_chip_batch=2, chip_counts="1,2", n_steps=2, **SMALL)
    table = result["table"]
    assert [r["n_chips"] for r in table] == [1, 2]
    assert table[0]["efficiency"] == 1.0
    for r in table:
        assert np.isfinite(r["audio_s_per_s_per_chip"]) and r["audio_s_per_s_per_chip"] > 0
        assert np.isfinite(r["efficiency"]) and r["mfu"] is None
    line = _last_json(capsys)
    assert line["metric"] == "dp_weak_scaling_efficiency" and line["card"] == "cpu"
    assert line["value"] == table[-1]["efficiency"]


def test_via_trainer_counts_the_loaders_steps(tmp_path, monkeypatch, capsys):
    import asr_chinese_e2e_tpu_torch.train.trainer as trainer_mod
    from asr_chinese_e2e_tpu_torch.data import native

    # the loader's Python wav reads: no native build racing other workers
    monkeypatch.setattr(native, "available", lambda: False)
    calls = [0]
    inner = trainer_mod.make_step_fns

    def counting(*a, **kw):
        init_fn, train_step, eval_step = inner(*a, **kw)

        def step(*sa, **skw):
            calls[0] += 1
            return train_step(*sa, **skw)

        return init_fn, step, eval_step

    monkeypatch.setattr(trainer_mod, "make_step_fns", counting)
    result = bench.via_trainer_main(
        n_batches=3, batch=2, seconds=1.0, corpus_dir=str(tmp_path / "corpus"), device="cpu",
        dtype="float32", log_every_iter=1, **TINY)
    assert calls[0] == 2 * 3  # two epochs of the loader's 3 batches
    line = _last_json(capsys)
    assert line == result
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "steps_per_s",
                         "label_boundary", "mfu", "card"}
    assert line["metric"] == "integrated_trainer_throughput_audio_seconds_per_sec_per_chip"
    assert line["value"] == pytest.approx(line["steps_per_s"] * 2 * 1.0)
    assert line["label_boundary"] >= 20 and line["mfu"] is None and line["card"] == "cpu"
