"""The port's streaming soak script on the CPU: its ``cmvn_stats`` equals
the JAX script's (imported by path, JAX on the CPU) at 1e-4 relative, its
train command is the JAX soak's recipe, and ``eval_phase`` serves a tiny
causal-band experiment over a dev manifest in both encode modes, bf16 and
f32 as the checkpoint and its f32 copy, writing the JAX script's fields."""

import json
import os

import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint
from asr_chinese_e2e_tpu_torch.utils.synth import write_wav16
from tests.test_torch_soak import _load
from tests.test_torch_stream import _stream_parts, silence, tone

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("soak_streaming")
    return _load("soak_flagship_torch").gen_corpus(
        str(root / "corpus"), n_train=8, n_eval=2, seconds_range=(0.6, 1.5))


def test_streaming_cmvn_stats_match_jax(corpus):
    ours = _load("soak_streaming_torch").cmvn_stats(corpus, n=6, device="cpu")
    theirs = _load("soak_streaming").cmvn_stats(corpus, n=6)
    for a, b in zip(ours, theirs):
        assert a == pytest.approx(b, rel=1e-4)


def test_streaming_train_command_is_the_jax_recipe():
    ours = _load("soak_streaming_torch").train_cmd(
        {"train": "t", "dev": "d", "test": "s", "vocab": "v"}, -24.0, 2.4)
    words = dict(zip(ours[4::2], ours[5::2]))
    for key, want in (("--attention_band", "50"), ("--norm_type", "pre"),
                      ("--dropout_rate", "0.0"), ("--noam_factor", "0.25"),
                      ("--warm_up", "150"), ("--cmvn_mode", "fixed"),
                      ("--causal_encoder", "true"), ("--cmvn_mean", "-24.000000"),
                      ("--eval_decode", "joint"), ("--spec_augment", "false")):
        assert words[key] == want, key


def test_eval_phase_serves_both_encode_modes(tmp_path):
    *_, tm, vocab, _ = _stream_parts()
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = Config(**tm.cfg.to_dict())
    cfg.build(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    cfg.save(str(exp / "config.json"))
    save_torch_checkpoint(str(exp), tm.state_dict(), vocab.fingerprint(), "best")
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    vocab.save(str(corpus / "vocab.json"))
    rows = []
    for i, freq in enumerate((523.0, 880.0, 660.0)):
        x = np.concatenate([silence(0.3), tone(1.4, freq), silence(0.5)])
        wav = str(corpus / f"dev_{i}.wav")
        write_wav16(wav, x.astype(np.float32) / 32767)
        rows.append({"wave": wav, "tgt": chr(0x4E00 + i), "frames": len(x)})
    with open(corpus / "dev.jsonl", "w") as f:
        f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in rows)
    soak = _load("soak_streaming_torch")
    out = soak.eval_phase("ctc_greedy", exp=str(exp), corpus=str(corpus),
                          out_dir=str(tmp_path), device="cpu")
    assert out == json.load(open(tmp_path / "eval_ctc_greedy.json"))
    assert out["dev_utts"] == 3 and out["f32_finals_match"] == "3/3"
    for prefix in ("", "f32_"):
        for key in ("incremental_cer", "offline_recognizer_cer", "finals_match",
                    "partials_emitted", "partial_ms_mean", "partial_ms_p95",
                    "inc_wall_s", "off_wall_s"):
            assert prefix + key in out
