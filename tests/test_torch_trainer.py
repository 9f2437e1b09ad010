"""The port's training slice end to end on the CPU: ``main.train`` on a tiny
synthetic corpus with the flagship's selections (fbank kernel, fused
attention, CTC kernel, hash dropout, SpecAugment; their plain versions run
on the CPU) and Python wav reading, so the test counts the same on every
machine. Checks that the loss falls, that checkpoints and ``index.json``
are written, that a resumed run continues at the saved step and epoch, and
that the best checkpoint decodes through the port's ``recognize``.

``Trainer.evaluate`` with each ``eval_decode`` mode (ctc_greedy,
attention_greedy, beam, joint) on converted weights records a
``decoded_cer`` equal to the JAX package's ``corpus_cer`` of the matching
JAX decode on the same dev batches."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu.decode import greedy as jax_greedy
from asr_chinese_e2e_tpu.decode.beam import beam_search as jax_beam_search
from asr_chinese_e2e_tpu.decode.cer import corpus_cer as jax_corpus_cer
from asr_chinese_e2e_tpu.decode.joint import joint_beam_search as jax_joint_beam_search
from asr_chinese_e2e_tpu.utils.experiment import feature_config_from as jax_feature_config_from
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.batching import BucketedLoader
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.main import train
from asr_chinese_e2e_tpu_torch.recognize import recognize
from asr_chinese_e2e_tpu_torch.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e_tpu_torch.train.trainer import Trainer
from asr_chinese_e2e_tpu_torch.utils.experiment import feature_config_from
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.test_torch_model import model_pair, tiny_config

torch.set_num_threads(2)

CORPUS_KW = dict(
    n_train=16, n_dev=4, n_test=4, n_tone_chars=6, vocab_size=20,
    seconds_range=(0.6, 1.5), tone_sec=0.3, seed=0,
)


def _run_kwargs(corpus, exp_root, **extra):
    kw = dict(
        vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest=corpus["test"],
        d_model=32, num_heads=4, head_dim=8, d_ff=64, num_encoder_layers=2,
        num_decoder_layers=2, n_mels=20, ctc_weight=0.3, dropout_rate=0.1,
        dropout_impl="hash", attn_impl="fused", fbank_impl="pallas",
        ctc_impl="pallas", spec_augment=True, freq_mask_param=4,
        time_mask_param=4, label_smoothing=0.1, batch_size=4, num_epoch=2,
        lr_schedule="constant", lr=3e-3, log_every_iter=1, eval_every_iter=0,
        save_every_iter=0, device="cpu", use_native_io=False, exp_root=exp_root,
        exp_name="run", max_target_len=16, seed=3,
    )
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer")
    corpus = make_synth_corpus(str(root / "corpus"), **CORPUS_KW)
    trainer = train(**_run_kwargs(corpus, str(root / "exp")))
    return corpus, trainer, str(root / "exp")


def _scalars(exp_dir):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_loss_falls_and_scalars_are_logged(run):
    _, trainer, _ = run
    rows = _scalars(trainer.exp_dir)
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == trainer.state.step == 8  # 16 utterances / 4, 2 epochs
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2])
    train_rows = [r for r in rows if "train/loss" in r]
    for key in ("train/ctc_loss", "train/ce_loss", "train/grad_norm", "lr",
                "train/audio_s_per_s_per_chip", "train/steps_per_s"):
        assert all(key in r for r in train_rows), key
    assert any("dev/cer" in r for r in rows) and any("test/loss" in r for r in rows)


def test_checkpoints_and_index_are_written(run):
    _, trainer, _ = run
    ckdir = os.path.join(trainer.exp_dir, "checkpoints")
    with open(os.path.join(ckdir, "index.json")) as f:
        index = json.load(f)
    assert index["latest"] == "e2_s8"
    assert index["best"] in index["all"] and index["best_metric"] is not None
    for name in index["all"]:
        assert os.path.exists(os.path.join(ckdir, name, "state.pt"))
        with open(os.path.join(ckdir, name, "meta.json")) as f:
            meta = json.load(f)
        assert meta["config"]["d_model"] == 32
    assert os.path.exists(os.path.join(trainer.exp_dir, "torch_checkpoints", "best.pt"))


def test_resume_continues_at_the_saved_step(run):
    corpus, trainer, exp_root = run
    resumed = train(**_run_kwargs(corpus, exp_root, from_ckpt="latest", num_epoch=3))
    assert resumed.optimizer.count == resumed.state.step == 12
    rows = [r for r in _scalars(resumed.exp_dir) if "train/loss" in r]
    steps = [r["step"] for r in rows]
    assert steps[-4:] == [9, 10, 11, 12]
    with open(os.path.join(resumed.exp_dir, "checkpoints", "index.json")) as f:
        assert json.load(f)["latest"] == "e3_s12"


def test_best_checkpoint_decodes_through_recognize(run, tmp_path):
    corpus, trainer, _ = run
    res = recognize(
        trainer.exp_dir, corpus["vocab"], manifest=corpus["test"], mode="beam",
        beam_size=2, batch_size=2, max_decode_len=6, device="cpu",
        out=str(tmp_path / "res.json"),
    )
    assert len(res["utts"]) == CORPUS_KW["n_test"]
    for entry in res["utts"].values():
        assert entry["output"] and all(np.isfinite(o["score"]) for o in entry["output"])


def test_conformer_conv2d_trains_and_decodes(run, tmp_path):
    """``main.train`` with ``--model_name Conformer`` and the conv2d
    frontend: the projection's width comes from the features (F = 80 here:
    ceil(ceil(80 / 2) / 2) x 48 / 8 = 120), whatever ``input_dim`` says,
    and the checkpoint decodes through ``recognize``."""
    corpus, _, _ = run
    trainer = train(**_run_kwargs(
        corpus, str(tmp_path / "exp"), model_name="Conformer", frontend="conv2d",
        d_model=48, conv_kernel_size=5, input_dim=320, num_epoch=1,
    ))
    model = trainer.model
    assert trainer.cfg.input_dim == 80 and model.cfg.encoder_type == "conformer"
    assert model.encoder.frontend_mod.proj.in_features == 120
    losses = [r["train/loss"] for r in _scalars(trainer.exp_dir) if "train/loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    res = recognize(trainer.exp_dir, corpus["vocab"], manifest=corpus["test"], mode="beam",
                    beam_size=2, batch_size=2, max_decode_len=6, device="cpu",
                    out=str(tmp_path / "res.json"))
    assert len(res["utts"]) == CORPUS_KW["n_test"]
    assert all(e["output"] for e in res["utts"].values())


def test_cli_takes_key_value_words(monkeypatch, capsys):
    import asr_chinese_e2e_tpu_torch.main as port_main

    seen = {}
    monkeypatch.setattr(port_main, "train", lambda **kw: seen.update(kw))
    monkeypatch.setattr(
        "sys.argv", ["main", "train", "lr=0.001", "--batch_size", "8", "spec_augment=true"]
    )
    port_main.main()
    assert seen == {"lr": 0.001, "batch_size": 8, "spec_augment": True}
    monkeypatch.setattr("sys.argv", ["main", "train", "oops"])
    with pytest.raises(SystemExit, match="oops"):
        port_main.main()
    monkeypatch.setattr("sys.argv", ["main"])
    port_main.main()
    assert "Training CLI" in capsys.readouterr().out


# -- decoded CER in evaluation, against the JAX decodes ------------------------

EVAL_MAX_LEN, EVAL_BEAM = 12, 3


@pytest.fixture(scope="module")
def eval_parts(tmp_path_factory):
    """A tiny model pair with the flagship's kernel selections, the dev
    loader of a synthetic corpus, and JAX's encoder output per dev batch."""
    root = tmp_path_factory.mktemp("torch_eval_decode")
    corpus = make_synth_corpus(str(root / "corpus"), **{**CORPUS_KW, "n_dev": 6})
    vocab = Vocab.load(corpus["vocab"])
    jcfg = tiny_config(input_dim=80, n_mels=20, fbank_impl="pallas", attn_impl="fused",
                       max_target_len=EVAL_MAX_LEN)
    jm, params, tm = model_pair(jcfg, vocab_size=vocab.vocab_size, seed=5)
    loader = BucketedLoader(
        corpus["dev"], vocab, batch_size=4, max_target_len=EVAL_MAX_LEN, shuffle=False,
        use_native_io=False, wire_dtype="int16", drop_last=False,
    )
    jfeat = jax_feature_config_from(jcfg)
    batches = []
    for batch in loader.epoch(0):
        feats, fl = jax_parse_batch(jnp.asarray(batch.wave), jnp.asarray(batch.wave_lengths),
                                    jfeat)
        enc, enc_len = jm.apply(params, feats, fl, method="encode")
        batches.append((batch.texts, enc, enc_len))
    return str(root), jcfg, jm, params, tm, vocab, loader, batches


def _jax_hyp_ids(mode, jm, params, enc, enc_len):
    if mode == "ctc_greedy":
        return jax_greedy.ctc_greedy_decode(
            jm.apply(params, enc, method="ctc_log_probs"), enc_len)
    if mode == "attention_greedy":
        tokens, _ = jax_greedy.attention_greedy_decode(jm, params, enc, enc_len, EVAL_MAX_LEN)
        return jax_greedy.tokens_to_ids(tokens)
    fn = jax_beam_search if mode == "beam" else jax_joint_beam_search
    res = fn(jm, params, enc, enc_len, EVAL_BEAM, EVAL_MAX_LEN)
    return [h[0] for h in res.nbest_ids(1)]


@pytest.mark.parametrize("mode", ["ctc_greedy", "attention_greedy", "beam", "joint"])
def test_evaluate_decoded_cer_matches_jax(eval_parts, mode):
    root, jcfg, jm, params, tm, vocab, loader, batches = eval_parts
    cfg = default_train_config().combine(Config(**jcfg.to_dict())).build(
        batch_size=4, eval_decode=mode, eval_beam_size=EVAL_BEAM, device="cpu",
        exp_root=os.path.join(root, "exp"), exp_name=mode, n_mels=20, fbank_impl="pallas",
        log_every_iter=1, eval_every_iter=0, save_every_iter=0, lr_schedule="constant",
        lr=1e-3,
    )
    optimizer = make_optimizer(tm.parameters(), cfg, cfg.d_model)
    trainer = Trainer(tm, optimizer, cfg, feature_config_from(cfg), vocab,
                      train_loader=loader, dev_loader=loader)
    trainer.state = trainer.init_fn()
    trainer.evaluate(loader, "dev/")
    row = _scalars(trainer.exp_dir)[-1]

    cers, counts = [], []
    for texts, enc, enc_len in batches:
        ids = _jax_hyp_ids(mode, jm, params, enc, enc_len)
        cers.append(jax_corpus_cer(["".join(vocab.ids_to_tokens(h)) for h in ids], texts))
        counts.append(len(texts))
    want = float(np.dot(cers, counts) / np.sum(counts))
    assert row["dev/decoded_cer"] == pytest.approx(want, rel=1e-6, abs=1e-9)
    assert "dev/cer" in row and len(batches) >= 2


def test_unknown_eval_decode_raises(eval_parts):
    root, jcfg, _, _, tm, vocab, loader, _ = eval_parts
    cfg = default_train_config().combine(Config(**jcfg.to_dict())).build(
        eval_decode="rescore", exp_root=os.path.join(root, "exp"), exp_name="bad",
        lr_schedule="constant", lr=1e-3)
    with pytest.raises(ValueError, match="eval_decode"):
        Trainer(tm, make_optimizer(tm.parameters(), cfg, cfg.d_model), cfg,
                feature_config_from(cfg), vocab, train_loader=loader)
