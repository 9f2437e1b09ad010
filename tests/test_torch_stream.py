"""The port's streaming recognizer against the JAX package's, on converted
weights: ``EnergyGate`` segments identical on the same int16 streams;
``StreamingRecognizer`` events (kind, text, t0, t1) identical for
``ctc_greedy``, ``beam`` and ``joint`` finals, prefix re-encode and
incremental, for a causal-banded transformer and conformer;
``reset_stream`` isolation; the argument checks; ``ctc_greedy_decode`` and
``attention_greedy_decode`` against JAX's; and the ``stream`` CLI on the
CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu.data.vocab import Vocab as JaxVocab
from asr_chinese_e2e_tpu.decode.greedy import attention_greedy_decode as jax_attn_greedy
from asr_chinese_e2e_tpu.decode.greedy import ctc_greedy_decode as jax_ctc_greedy
from asr_chinese_e2e_tpu.decode.greedy import tokens_to_ids as jax_tokens_to_ids
from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.stream import EnergyGate as JaxGate
from asr_chinese_e2e_tpu.stream import StreamingRecognizer as JaxRecognizer
from asr_chinese_e2e_tpu_torch import stream
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.decode.greedy import (
    attention_greedy_decode,
    ctc_greedy_decode,
    tokens_to_ids,
)
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
from asr_chinese_e2e_tpu_torch.stream import EnergyGate, StreamingRecognizer
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint
from asr_chinese_e2e_tpu_torch.utils.synth import write_wav16
from tests.test_streaming_encoder import stream_cfg

torch.set_num_threads(2)

SR = 16000


def tone(seconds, freq=440.0, amp=0.5):
    t = np.arange(int(SR * seconds)) / SR
    return (np.sin(2 * np.pi * freq * t) * amp * 32767).astype(np.int16)


def silence(seconds):
    return np.zeros((int(SR * seconds),), np.int16)


def feed_chunked(gate_or_rec, x, chunk=1600):
    out = []
    for i in range(0, len(x), chunk):
        out.extend(gate_or_rec.feed(x[i : i + chunk]))
    out.extend(gate_or_rec.finish())
    return out


STREAMS = {
    "two-runs": lambda: np.concatenate(
        [silence(0.5), tone(0.8), silence(2.0), tone(1.2), silence(1.5)]),
    "subthreshold": lambda: (np.random.RandomState(0).randn(SR * 2) * 100).astype(np.int16),
    "long-run": lambda: tone(4.0),
    "noisy": lambda: (np.random.RandomState(1).randn(SR * 5)
                      * np.repeat(np.random.RandomState(2).rand(50) > 0.5, SR // 10)
                      * 2000).astype(np.int16),
}


@pytest.mark.parametrize("name", list(STREAMS))
@pytest.mark.parametrize("chunk", [1600, 2000, 777])
def test_energy_gate_matches_jax(name, chunk):
    x = STREAMS[name]()
    kw = dict(max_segment_samples=SR)
    ours, theirs = EnergyGate(**kw), JaxGate(**kw)
    for _ in range(2):  # the second pass after reset sees a fresh stream
        got, want = feed_chunked(ours, x, chunk), feed_chunked(theirs, x, chunk)
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ours.reset()
        theirs.reset()


def _stream_parts(**overrides):
    """A tiny causal-band model with a CTC head and fixed CMVN (JAX side),
    and its twin in the port."""
    jvocab = JaxVocab()
    jvocab.consume_sentence("".join(chr(0x4E00 + i) for i in range(8)))
    jvocab.build()
    jfeat = JaxFeatureConfig(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    cfg = stream_cfg(ctc_weight=0.3, **overrides)
    cfg.build(input_dim=jfeat.feature_dim)
    jm = JaxModel(cfg, jvocab.vocab_size)
    feats, feat_lens = jax_parse_batch(
        np.zeros((1, SR), np.float32), np.asarray([SR], np.int32), jfeat
    )
    params = jm.init(
        jax.random.PRNGKey(0), feats, feat_lens,
        np.zeros((1, 4), np.int32), np.asarray([1], np.int32),
    )
    pcfg = Config(**cfg.to_dict())
    tm = SpeechTransformer(pcfg, jvocab.vocab_size)
    tm.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), pcfg,
                                             jvocab.vocab_size))
    vocab = Vocab()
    vocab.consume_sentence("".join(chr(0x4E00 + i) for i in range(8)))
    vocab.build()
    feat = FeatureConfig(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    return jm, params, jvocab, jfeat, tm.eval(), vocab, feat


@pytest.fixture(scope="module")
def parts():
    return _stream_parts()


@pytest.fixture(scope="module")
def conformer_parts():
    """The same with a causal conformer encoder (depthwise conv k = 5)."""
    return _stream_parts(encoder_type="conformer", conv_kernel_size=5)


def _speech():
    return np.concatenate([
        silence(0.4), tone(0.9, 523.0), silence(1.6), tone(0.6, 880.0),
        silence(0.3), tone(1.3, 660.0),  # ends mid-speech: closed by finish()
    ])


def _events_match_jax(parts, mode, incremental):
    jm, params, jvocab, jfeat, tm, vocab, feat = parts
    kw = dict(mode=mode, bucket_seconds=(1.0, 2.0), partial_every_s=0.4,
              beam_size=3, max_len=8, chunk_frames=8, incremental=incremental)
    rec = StreamingRecognizer(tm, vocab, feat, **kw)
    jrec = JaxRecognizer(jm, params, jvocab, jfeat, **kw)
    assert rec.incremental == jrec.incremental == (incremental == "on")
    x = _speech()
    got = [(e.kind, e.text, e.t0, e.t1) for e in feed_chunked(rec, x)]
    want = [(e.kind, e.text, e.t0, e.t1) for e in feed_chunked(jrec, x)]
    assert got == want
    assert [k for k, *_ in got].count("final") == 3 and ("partial" in [k for k, *_ in got])
    assert any(text for _, text, *_ in got)  # the tiny model emits characters


@pytest.mark.parametrize("incremental", ["on", "off"])
@pytest.mark.parametrize("mode", ["ctc_greedy", "beam", "joint"])
def test_recognizer_events_match_jax(parts, mode, incremental):
    _events_match_jax(parts, mode, incremental)


@pytest.mark.parametrize("incremental", ["on", "off"])
@pytest.mark.parametrize("mode", ["ctc_greedy", "beam", "joint"])
def test_conformer_recognizer_events_match_jax(conformer_parts, mode, incremental):
    _events_match_jax(conformer_parts, mode, incremental)


def _finals_equal_prefix_reencode(parts, mode):
    _, _, _, _, tm, vocab, feat = parts
    finals = {}
    for inc in ("on", "off"):
        rec = StreamingRecognizer(tm, vocab, feat, mode=mode, bucket_seconds=(1.0, 2.0),
                                  beam_size=3, max_len=8, chunk_frames=8, incremental=inc)
        finals[inc] = [(e.text, e.t0, e.t1) for e in feed_chunked(rec, _speech())
                       if e.kind == "final"]
    assert finals["on"] == finals["off"]


@pytest.mark.parametrize("mode", ["beam", "joint"])
def test_incremental_finals_equal_prefix_reencode(parts, mode):
    _finals_equal_prefix_reencode(parts, mode)


@pytest.mark.parametrize("mode", ["beam", "joint"])
def test_conformer_incremental_finals_equal_prefix_reencode(conformer_parts, mode):
    _finals_equal_prefix_reencode(conformer_parts, mode)


def test_reset_stream_isolates_streams(parts):
    _, _, _, _, tm, vocab, feat = parts
    tt = np.arange(int(0.8 * SR)) / SR
    seg = (np.sin(2 * np.pi * 523.0 * tt) * 12000).astype(np.int16)
    other = (np.sin(2 * np.pi * 880.0 * tt) * 12000).astype(np.int16)
    for inc in ("on", "off"):
        rec = StreamingRecognizer(tm, vocab, feat, bucket_seconds=(1.0, 2.0),
                                  chunk_frames=8, incremental=inc)
        want = [e.text for e in feed_chunked(rec, seg) if e.kind == "final"]
        feed_chunked(rec, other[:9000])  # ends mid-speech
        rec.feed(other[:5000])  # and leave a segment open
        rec.reset_stream()
        assert [e.text for e in feed_chunked(rec, seg) if e.kind == "final"] == want


def test_argument_checks(parts):
    _, _, _, _, tm, vocab, feat = parts
    with pytest.raises(ValueError, match="mode"):
        StreamingRecognizer(tm, vocab, feat, mode="rescore")
    with pytest.raises(ValueError, match="incremental"):
        StreamingRecognizer(tm, vocab, feat, incremental="On")
    with pytest.raises(ValueError, match="incremental"):  # per-utterance CMVN
        StreamingRecognizer(tm, vocab, FeatureConfig(n_mels=20), incremental="on")
    assert StreamingRecognizer(tm, vocab, feat).incremental
    assert not StreamingRecognizer(tm, vocab, FeatureConfig(n_mels=20)).incremental


def test_ctc_greedy_decode_matches_jax():
    rng = np.random.RandomState(0)
    lp = rng.randn(3, 17, 6).astype(np.float32)
    lp[:, ::3, 0] += 3.0  # blanks between runs
    lp[1, 4:9, 2] += 5.0  # a repeat to collapse
    lp[2, 7, [1, 4]] = 50.0  # a tie: the first index wins
    lens = np.asarray([17, 11, 9], np.int32)
    want = jax_ctc_greedy(jnp.asarray(lp), jnp.asarray(lens))
    assert ctc_greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens)) == want
    assert any(want)


def test_attention_greedy_decode_matches_jax(parts):
    jm, params, _, jfeat, tm, _, _ = parts
    rng = np.random.RandomState(4)
    enc = rng.randn(2, 11, 32).astype(np.float32)
    lens = np.asarray([11, 7], np.int32)
    j_tok, j_scores = jax_attn_greedy(jm, params, jnp.asarray(enc), jnp.asarray(lens), 6)
    tok, scores = attention_greedy_decode(tm, torch.from_numpy(enc), torch.from_numpy(lens), 6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(j_tok))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), atol=1e-4, rtol=0)
    assert tokens_to_ids(tok) == jax_tokens_to_ids(np.asarray(j_tok))


def test_stream_cli_on_the_cpu(parts, tmp_path, capsys):
    _, _, _, _, tm, vocab, feat = parts
    exp = tmp_path / "exp"
    exp.mkdir()
    cfg = Config(**tm.cfg.to_dict())
    cfg.build(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    cfg.save(str(exp / "config.json"))
    vocab.save(str(tmp_path / "vocab.json"))
    save_torch_checkpoint(str(exp), tm.state_dict(), vocab.fingerprint(), "best")
    x = _speech()
    write_wav16(str(tmp_path / "a.wav"), x.astype(np.float32) / 32767)
    stream.main(["--exp", str(exp), "--vocab", str(tmp_path / "vocab.json"),
                 "--wav", str(tmp_path / "a.wav"), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("# encode path: incremental")
    # the CLI prints the events of the default recognizer fed 125 ms chunks
    rec = StreamingRecognizer(tm, vocab, feat)
    events = feed_chunked(rec, x, chunk=2000)
    assert lines[1:] == [f"[{e.kind:7s} {e.t0:6.2f}-{e.t1:6.2f}s] {e.text}" for e in events]
    assert [e.kind for e in events].count("final") == 2


def test_wav_chunks_roundtrip(tmp_path):
    x = tone(0.5, amp=0.3)
    p = str(tmp_path / "t.wav")
    write_wav16(p, x.astype(np.float32) / 32767)
    got = np.concatenate(list(stream.wav_chunks(p, 1000)))
    assert got.dtype == np.int16 and len(got) == len(x)
    np.testing.assert_allclose(got, x, atol=2)
