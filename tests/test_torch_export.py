"""``scripts/export_torch_checkpoint.py``: a tiny JAX experiment saved with
the JAX ``CheckpointManager``, exported, and loaded with the port's
``load_experiment`` encodes like the JAX model (f32, 1e-4 abs)."""

import json
import os
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu.core.registry import get_model as jax_get_model
from asr_chinese_e2e_tpu.data.vocab import Vocab as JaxVocab
from asr_chinese_e2e_tpu.models.rnn import default_las_config
from asr_chinese_e2e_tpu.train.checkpoint import CheckpointManager
from asr_chinese_e2e_tpu.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e_tpu.train.train_step import make_step_fns
from asr_chinese_e2e_tpu_torch.data.features import parse_batch
from asr_chinese_e2e_tpu_torch.utils.experiment import load_experiment
from tests.test_torch_model import tiny_config

torch.set_num_threads(2)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "export_torch_checkpoint.py"


def _jax_experiment(root: Path, model_cfg=None):
    """Write config.json, vocab.json and one orbax checkpoint (no best) of a
    tiny SpeechTransformer, or of the registry model ``model_cfg`` names."""
    vocab = JaxVocab()
    vocab.consume_sentence("今天天气很好你好")
    vocab.build()
    vocab_path = str(root / "vocab.json")
    vocab.save(vocab_path)
    if model_cfg is None:
        model_cfg = tiny_config(input_dim=80, n_mels=20, dropout_rate=0.0)
    cfg = default_train_config().combine(model_cfg)
    exp = root / "exp"
    exp.mkdir()
    cfg.save(str(exp / "config.json"))
    model = jax_get_model(cfg.get("model_name", "SpeechTransformer"))[0](cfg, vocab.vocab_size)
    feat_cfg = JaxFeatureConfig(n_mels=20)
    tx = make_optimizer(cfg, cfg.get("d_model", cfg.get("hidden_size", 512)))
    init_fn, _, _ = make_step_fns(model, tx, feat_cfg, cfg)
    dummy = {
        "wave": np.zeros((1, 16000), np.float32),
        "wave_lengths": np.asarray([16000], np.int32),
        "labels": np.zeros((1, 4), np.int32),
        "label_lengths": np.asarray([1], np.int32),
    }
    state = init_fn(jax.random.PRNGKey(3), dummy)
    mgr = CheckpointManager(str(exp / "checkpoints"))
    mgr.save(state, epoch=0, config=cfg, vocab_fingerprint=vocab.fingerprint(), step=0)
    mgr.wait()
    return str(exp), vocab_path, model, state.params, feat_cfg


def test_export_then_load_encodes_like_jax(tmp_path, monkeypatch, capsys):
    exp, vocab_path, jm, params, feat_cfg = _jax_experiment(tmp_path)
    monkeypatch.setattr(
        sys, "argv", ["export_torch_checkpoint.py", "--exp", exp, "--vocab", vocab_path]
    )
    runpy.run_path(str(SCRIPT), run_name="__main__")  # the CLI, in this process
    written = capsys.readouterr().out.strip().splitlines()[-1]
    assert written == os.path.join(exp, "torch_checkpoints", "best.pt")

    model, cfg, tfeat_cfg, voc = load_experiment(exp, vocab_path, "best", device="cpu")
    assert voc.fingerprint() == JaxVocab.load(vocab_path).fingerprint()
    assert tfeat_cfg.n_mels == 20 and cfg.d_model == 32

    rng = np.random.RandomState(0)
    wave = (rng.randn(2, 9000) * 3000).astype(np.int16)
    lens = np.asarray([9000, 6100], np.int32)
    jf, jl = jax_parse_batch(jnp.asarray(wave), jnp.asarray(lens), feat_cfg)
    want, _ = jm.apply(params, jf, jl, method="encode")
    with torch.no_grad():
        tf, tl = parse_batch(torch.from_numpy(wave), torch.from_numpy(lens), tfeat_cfg)
        got, _ = model.encode(tf, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_load_rejects_other_vocab(tmp_path):
    exp, vocab_path, *_ = _jax_experiment(tmp_path)
    runpy.run_path(str(SCRIPT))["export"](exp, vocab_path, "latest")
    other = json.loads(Path(vocab_path).read_text())
    other["id2token"] = other["id2token"][:-1]
    other_path = tmp_path / "other_vocab.json"
    other_path.write_text(json.dumps(other, ensure_ascii=False))
    with pytest.raises(ValueError, match="fingerprint"):
        load_experiment(exp, str(other_path), "latest", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_experiment(exp, vocab_path, "e9_s9", device="cpu")


def test_export_then_load_rnn_experiment(tmp_path):
    """A LAS experiment of the JAX package exports (its encoder cells in
    flax's creation order) and the port's ``load_experiment`` builds a LAS
    that encodes and scores a decode step like the JAX model (f32,
    1e-4)."""
    las = default_las_config().build(
        model_name="LAS", n_mels=20, hidden_size=8, embed_dim=6, attention_dim=6,
        location_kernel=5, num_encoder_layers=2, dropout_rate=0.0)
    exp, vocab_path, jm, params, feat_cfg = _jax_experiment(tmp_path, las)
    runpy.run_path(str(SCRIPT))["export"](exp, vocab_path, "latest")
    model, cfg, tfeat_cfg, _ = load_experiment(exp, vocab_path, "latest", device="cpu")
    assert type(model).__name__ == "LAS" and cfg.input_dim == tfeat_cfg.feature_dim

    rng = np.random.RandomState(1)
    wave = (rng.randn(2, 9000) * 3000).astype(np.int16)
    lens = np.asarray([9000, 6100], np.int32)
    jf, jl = jax_parse_batch(jnp.asarray(wave), jnp.asarray(lens), feat_cfg)
    want, want_len = jm.apply(params, jf, jl, method="encode")
    state = jm.apply(params, want, want_len, method="init_decode_state")
    want_lp, _ = jm.apply(params, jnp.asarray([2, 5]), state, method="decode_step")
    with torch.no_grad():
        tf, tl = parse_batch(torch.from_numpy(wave), torch.from_numpy(lens), tfeat_cfg)
        got, got_len = model.encode(tf, tl)
        got_lp, _ = model.decode_step(torch.tensor([2, 5]),
                                      model.init_decode_state(got, got_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-4, rtol=0)
