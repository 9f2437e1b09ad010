"""The port's RNN family and ``ExampleModel`` in training and serving, on
the CPU: train steps against the JAX package's (numpy-seeded inputs,
flax-converted weights, f32, tolerances stated per test), the trainer and
``main.train`` on a tiny synthetic corpus, ``recognize`` in every mode the
JAX package serves these models in, ``load_experiment`` and the streaming
recognizer. Also the repairs the family needed: Noam's width is
``hidden_size`` when there is no ``d_model``, and evaluation runs without
teacher-forced logits."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.train.optimizer import current_lr as jax_current_lr
from asr_chinese_e2e_tpu.train.optimizer import default_train_config as jax_train_config
from asr_chinese_e2e_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from asr_chinese_e2e_tpu.train.train_step import make_step_fns as jax_make_step_fns
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.main import train
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.rnn import LAS, BiLSTMCTC
from asr_chinese_e2e_tpu_torch.recognize import recognize
from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer, wav_chunks
from asr_chinese_e2e_tpu_torch.train.optimizer import (
    default_train_config,
    make_optimizer,
    model_width,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns
from asr_chinese_e2e_tpu_torch.utils.experiment import load_experiment
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.test_torch_rnn import (
    ARGS,
    CFGS,
    JAX_CLASSES,
    PORT_CLASSES,
    VOCAB,
    _t,
    batch,
    ctc_cfg,
    example_cfg,
    pair,
)

torch.set_num_threads(2)


# -- train steps ----------------------------------------------------------------

STEP_OVERRIDES = dict(lr_schedule="noam", warmup=10, noam_factor=1.0)


def _jax_run(name, cfg, b, n_steps):
    tcfg = jax_train_config().combine(cfg).build(rng_impl="threefry2x32", **STEP_OVERRIDES)
    jm = JAX_CLASSES[name](cfg, VOCAB)
    width = cfg.get("d_model", cfg.get("hidden_size", 512))
    init_fn, train_step, _ = jax_make_step_fns(
        jm, jax_make_optimizer(tcfg, width), JaxFeatureConfig(), tcfg, raw_features=True)
    state = init_fn(jax.random.PRNGKey(42), b)
    params = jax.tree.map(np.asarray, state.params)
    args = [jnp.asarray(b[k]) for k in ARGS]
    losses = []
    for _ in range(n_steps):
        state, m = train_step(state, *args, jax.random.key(42, impl="threefry2x32"))
        losses.append(float(m["loss"]))
    return params, losses, state


def _port_run(name, cfg, params, b, n_steps):
    pcfg = Config(**cfg.to_dict())
    tm = PORT_CLASSES[name](pcfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, pcfg, VOCAB))
    tcfg = default_train_config().combine(pcfg).build(**STEP_OVERRIDES)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the Noam peak warning of a tiny width
        opt = make_optimizer(tm.parameters(), tcfg, model_width(pcfg))
    init_fn, train_step, _ = make_step_fns(tm, opt, FeatureConfig(), tcfg, raw_features=True)
    state = init_fn()
    losses = []
    for _ in range(n_steps):
        state, m = train_step(state, *_t(b), 0)
        losses.append(float(m["loss"]))
    return tm, losses


def _same_weights(tm, jparams):
    want = torch_state_from_flax(jax.tree.map(np.asarray, jparams), tm.cfg, VOCAB)
    assert want.keys() == tm.state_dict().keys()
    for key, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["BiLSTMCTC", "LAS"])
def test_train_steps_match_jax(name):
    """3 train steps at dropout 0 from the converted JAX init, Noam at the
    model's width (hidden_size): the losses within rtol 1e-5 and the
    updated weights within 1e-5 of JAX's."""
    cfg = CFGS[name]()
    b = batch()
    params, j_losses, jstate = _jax_run(name, cfg, b, 3)
    tm, losses = _port_run(name, cfg, params, b, 3)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _same_weights(tm, jstate.params)


def test_example_model_one_step_matches_jax():
    """``ExampleModel``: logits, loss (rtol 1e-5) and the weights after one
    clip + Adam + Noam update (1e-5) against JAX's loss gradient and optax
    update (XLA on the CPU compiles the JAX package's whole jitted step of
    this model in minutes, so the step is taken in its two parts)."""
    import optax

    from asr_chinese_e2e_tpu.losses import model_loss as jax_model_loss

    cfg = example_cfg()
    jm, params, _ = pair("ExampleModel", cfg)
    b = batch()
    jin = [jnp.asarray(b[k]) for k in ARGS]

    def loss(p):
        return jax_model_loss(jm.apply(p, *jin), jin[2], jin[3], 0.0, 0.0)[0]

    j_loss, grads = jax.jit(jax.value_and_grad(loss))(params)
    tx = jax_make_optimizer(
        jax_train_config().combine(cfg).build(**STEP_OVERRIDES), cfg.hidden_size)
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    tm, losses = _port_run("ExampleModel", cfg, params, b, 1)
    np.testing.assert_allclose(losses, [float(j_loss)], rtol=1e-5)
    _same_weights(tm, optax.apply_updates(params, updates))


def test_bilstm_ctc_eval_step_runs_without_logits():
    """A CTC-only model's evaluation gives its loss and no teacher-forced
    ids (the JAX package's eval step checks for ``logits``)."""
    _, _, tm = pair("BiLSTMCTC", ctc_cfg())
    tcfg = default_train_config().combine(Config(**ctc_cfg().to_dict())).build(
        lr_schedule="constant", lr=1e-3)
    opt = make_optimizer(tm.parameters(), tcfg, model_width(tcfg))
    _, _, eval_step = make_step_fns(tm, opt, FeatureConfig(), tcfg, raw_features=True)
    metrics = eval_step(*_t(batch()))
    assert set(metrics) == {"loss", "ctc_loss"}
    assert np.isfinite(float(metrics["loss"]))


# -- trainer, main.train, recognize, stream ------------------------------------

CORPUS_KW = dict(
    n_train=8, n_dev=4, n_test=4, n_tone_chars=6, vocab_size=20,
    seconds_range=(0.6, 1.2), tone_sec=0.3, seed=0,
)


def _run_kwargs(corpus, exp_root, **extra):
    kw = dict(
        vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest=corpus["test"], n_mels=20,
        fbank_impl="pallas", ctc_impl="pallas", spec_augment=True, freq_mask_param=4,
        time_mask_param=4, num_time_warps=1, time_warp_param=3, batch_size=4,
        num_epoch=2, log_every_iter=1, eval_every_iter=0, save_every_iter=0,
        device="cpu", use_native_io=False, exp_root=exp_root, max_target_len=16, seed=3,
        hidden_size=16, num_encoder_layers=2,
    )
    kw.update(extra)
    return kw


def _scalars(exp_dir):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def rnn_runs(tmp_path_factory):
    """BiLSTMCTC (constant LR 5e-3, ``eval_decode="ctc_greedy"``) and LAS
    (Noam at its width, ``eval_decode="beam"``) trained 2 epochs by
    ``main.train`` on a tiny synthetic corpus, SpecAugment with time-warp."""
    root = tmp_path_factory.mktemp("torch_rnn")
    corpus = make_synth_corpus(str(root / "corpus"), **CORPUS_KW)
    exp_root = str(root / "exp")
    ctc = train(**_run_kwargs(corpus, exp_root, model_name="BiLSTMCTC", exp_name="ctc",
                              lr_schedule="constant", lr=5e-3, eval_decode="ctc_greedy"))
    las = train(**_run_kwargs(corpus, exp_root, model_name="LAS", exp_name="las",
                              embed_dim=12, attention_dim=12, location_kernel=5,
                              warmup=4, eval_decode="beam", eval_beam_size=2))
    return corpus, ctc, las


def test_bilstm_ctc_trainer_run(rnn_runs):
    """The port's counterpart of tests/test_trainer_e2e.py on the north-star
    config #1: the loss falls, every dev row has a decoded CER and no
    teacher-forced CER, checkpoints are written."""
    _, trainer, _ = rnn_runs
    assert isinstance(trainer.model, BiLSTMCTC) and trainer.model.cfg.ctc_weight == 1.0
    rows = _scalars(trainer.exp_dir)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    dev = [r for r in rows if "dev/loss" in r]
    assert len(dev) == 2
    assert all("dev/decoded_cer" in r and "dev/cer" not in r for r in dev)
    assert os.path.exists(os.path.join(trainer.exp_dir, "checkpoints", "index.json"))


def test_las_noam_rate_is_jax_current_lr(rnn_runs):
    """The logged LR of a LAS run is the JAX package's ``current_lr`` at
    ``hidden_size`` (LAS has no d_model), and so is the optimizer's."""
    _, _, trainer = rnn_runs
    cfg = trainer.cfg
    assert "d_model" not in cfg.to_dict() and model_width(cfg) == 16
    rows = [r for r in _scalars(trainer.exp_dir) if "lr" in r]
    assert rows
    for r in rows:
        assert r["lr"] == pytest.approx(jax_current_lr(cfg, cfg.hidden_size, r["step"]),
                                        rel=1e-6)
    dev = [r for r in _scalars(trainer.exp_dir) if "dev/loss" in r]
    assert all("dev/decoded_cer" in r and "dev/cer" in r for r in dev)


def test_recognize_serves_the_rnn_models(rnn_runs):
    """LAS in every mode the JAX package serves it in, BiLSTMCTC in
    ``ctc_greedy``; the modes JAX cannot run for them raise here too."""
    corpus, ctc, las = rnn_runs
    kw = dict(manifest=corpus["test"], beam_size=2, batch_size=2, max_decode_len=6,
              device="cpu")
    for mode in ("ctc_greedy", "attention_greedy", "beam", "joint"):
        res = recognize(las.exp_dir, corpus["vocab"], mode=mode, **kw)
        assert len(res["utts"]) == CORPUS_KW["n_test"], mode
    res = recognize(ctc.exp_dir, corpus["vocab"], mode="ctc_greedy", **kw)
    assert len(res["utts"]) == CORPUS_KW["n_test"]
    with pytest.raises(AttributeError, match="decode_logits"):
        recognize(las.exp_dir, corpus["vocab"], mode="rescore", **kw)
    for mode in ("attention_greedy", "beam", "rescore", "joint"):
        with pytest.raises(AttributeError):
            recognize(ctc.exp_dir, corpus["vocab"], mode=mode, **kw)


def test_load_experiment_builds_the_registry_model(rnn_runs):
    corpus, _, las = rnn_runs
    model, cfg, feat_cfg, _ = load_experiment(las.exp_dir, corpus["vocab"], device="cpu")
    assert isinstance(model, LAS) and cfg.input_dim == feat_cfg.feature_dim == 80
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert not model.training


def test_stream_serves_las_by_prefix_re_encode(rnn_runs):
    """``StreamingRecognizer`` serves an RNN model as the JAX package's
    does: prefix re-encode (no causal encoder, so no incremental mode),
    partials by CTC greedy, finals by beam."""
    corpus, _, las = rnn_runs
    model, _, feat_cfg, vocab = load_experiment(las.exp_dir, corpus["vocab"], device="cpu")
    rec = StreamingRecognizer(model, vocab, feat_cfg, mode="beam", beam_size=2, max_len=6)
    assert not rec.incremental
    wav = json.loads(open(corpus["test"]).readline())["wave"]
    events = []
    for chunk in wav_chunks(wav, 1600):
        events += rec.feed(chunk)
    events += rec.finish()
    assert events and events[-1].kind == "final"
