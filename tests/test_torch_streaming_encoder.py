"""The port's chunked streaming encoder against the JAX package's, on
converted weights, f32: ``encode_chunk`` (pre-LN, post-LN, DeepNorm) at
several chunk sizes against JAX's ``encode_chunk`` and against the port's
own offline encode, rtol/atol 2e-5 (the JAX tests' tolerance), and the
causal-banded conformer's (k = 5: attention tail and causal-conv carry)
the same way, with its causality; ``init_chunk_state`` for both encoder
families; the positional table at an offset; and the
incremental pipeline's accumulated output against the offline encode of
the bucketed wave, with a mid-speech cut, 2e-4 (the JAX tests' bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu.data.vocab import Vocab as JaxVocab
from asr_chinese_e2e_tpu.models.layers import sinusoid_table
from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.models.transformer import init_chunk_state as jax_init_chunk_state
from asr_chinese_e2e_tpu.stream import StreamingRecognizer as JaxRecognizer
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig, parse_batch
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.layers import PositionalEncoding
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer, init_chunk_state
from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer
from tests.test_streaming_encoder import BAND, make_model, stream_cfg
from tests.test_transformer import VOCAB

torch.set_num_threads(2)

TOL = 2e-5
CONFIGS = {
    "pre": dict(norm_type="pre"),
    "post": dict(norm_type="post"),
    "deepnorm": dict(norm_type="post", deepnorm=True),
}
_PAIRS = {}


def _pair(name):
    """(jax model, params, port model with converted weights, feats, lens)."""
    if name not in _PAIRS:
        cfg = stream_cfg(**CONFIGS[name])
        jm, params, feats, lens = make_model(cfg)
        pcfg = Config(**cfg.to_dict())
        tm = SpeechTransformer(pcfg, VOCAB)
        tm.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), pcfg,
                                                 VOCAB))
        _PAIRS[name] = (jm, params, tm.eval(), np.array(feats), np.array(lens))
    return _PAIRS[name]


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("chunk", [1, 5, 7, 20])
def test_encode_chunk_matches_jax_and_offline(name, chunk):
    jm, params, tm, feats, lens = _pair(name)
    t = feats.shape[1]
    j_tails = jm.apply(params, feats.shape[0], method="init_chunk_tails")
    t_tails = tm.init_chunk_tails(feats.shape[0])
    got, want = [], []
    with torch.no_grad():
        for off in range(0, t, chunk):
            piece = feats[:, off : off + chunk]
            pad = chunk - piece.shape[1]
            if pad:  # final flush chunk: pad, keep only the valid rows
                piece = np.pad(piece, ((0, 0), (0, pad), (0, 0)))
            j_enc, j_tails, j_lp = jm.apply(
                params, jnp.asarray(piece), j_tails, jnp.int32(off), method="encode_chunk"
            )
            t_enc, t_tails, t_lp = tm.encode_chunk(torch.from_numpy(piece), t_tails, off)
            np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=TOL, atol=TOL)
            for a, b in zip(t_tails, j_tails):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
            got.append(t_enc.numpy()[:, : chunk - pad])
            want.append(np.asarray(j_enc)[:, : chunk - pad])
        offline, _ = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, offline.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_chunk_state_matches_jax(dtype):
    cfg = stream_cfg(dtype=dtype)
    want = jax_init_chunk_state(cfg, 3)
    got = init_chunk_state(Config(**cfg.to_dict()), 3)
    assert len(got) == len(want) == cfg.num_encoder_layers
    for a, b in zip(got, want):
        assert a.shape == b.shape and str(a.dtype).endswith(str(b.dtype))
        assert not a.any()


def test_init_chunk_state_conformer_raises():
    """The conformer's chunk state, per layer: a (B, band, d) input tail
    and a (B, k-1, d) conv carry, zero, in the compute dtype, as JAX's."""
    for dtype, want_dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = stream_cfg(encoder_type="conformer", conv_kernel_size=5, dtype=dtype)
        want = jax_init_chunk_state(cfg, 3)
        got = init_chunk_state(Config(**cfg.to_dict()), 3)
        assert len(got) == len(want) == cfg.num_encoder_layers
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"tail", "conv"}
            assert a["tail"].shape == b["tail"].shape == (3, BAND, cfg.d_model)
            assert a["conv"].shape == b["conv"].shape == (3, 4, cfg.d_model)
            for key in a:
                assert a[key].dtype == want_dtype and not a[key].any()
    # encode_chunk reads frames, so the conv2d frontend cannot stream
    cfg = Config(**stream_cfg(encoder_type="conformer", frontend="conv2d").to_dict())
    model = SpeechTransformer(cfg, VOCAB)
    with pytest.raises(ValueError, match="linear frontend"):
        model.encode_chunk(torch.zeros(1, 4, cfg.input_dim), model.init_chunk_tails(1), 0)


def _conformer_pair():
    if "conformer" not in _PAIRS:
        cfg = stream_cfg(encoder_type="conformer", conv_kernel_size=5)
        jm, params, feats, lens = make_model(cfg)
        pcfg = Config(**cfg.to_dict())
        tm = SpeechTransformer(pcfg, VOCAB)
        tm.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), pcfg,
                                                 VOCAB))
        _PAIRS["conformer"] = (jm, params, tm.eval(), np.array(feats), np.array(lens))
    return _PAIRS["conformer"]


@pytest.mark.parametrize("chunk", [1, 4, 7])
def test_conformer_encode_chunk_matches_jax_and_offline(chunk):
    """Both carries (attention tail, causal-conv input) against JAX's, and
    the chunked output against JAX's chunks and the port's offline encode."""
    jm, params, tm, feats, lens = _conformer_pair()
    t = feats.shape[1]
    j_tails = jm.apply(params, feats.shape[0], method="init_chunk_tails")
    t_tails = tm.init_chunk_tails(feats.shape[0])
    got, want = [], []
    with torch.no_grad():
        for off in range(0, t, chunk):
            piece = feats[:, off : off + chunk]
            pad = chunk - piece.shape[1]
            if pad:
                piece = np.pad(piece, ((0, 0), (0, pad), (0, 0)))
            j_enc, j_tails, j_lp = jm.apply(
                params, jnp.asarray(piece), j_tails, jnp.int32(off), method="encode_chunk"
            )
            t_enc, t_tails, t_lp = tm.encode_chunk(torch.from_numpy(piece), t_tails, off)
            np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), rtol=TOL, atol=TOL)
            for a, b in zip(t_tails, j_tails):
                for key in ("tail", "conv"):
                    np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]), rtol=TOL,
                                               atol=TOL)
            got.append(t_enc.numpy()[:, : chunk - pad])
            want.append(np.asarray(j_enc)[:, : chunk - pad])
        offline, _ = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    got = np.concatenate(got, axis=1)
    np.testing.assert_allclose(got, np.concatenate(want, axis=1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, offline.numpy(), rtol=TOL, atol=TOL)


def test_causal_conformer_is_causal():
    """Past outputs do not move when future frames do: the depthwise conv
    pads on the left only under ``causal_encoder``."""
    _, _, tm, feats, lens = _conformer_pair()
    bumped = feats.copy()
    bumped[:, 12:] += 3.0
    with torch.no_grad():
        base, _ = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
        out, _ = tm.encode(torch.from_numpy(bumped), torch.from_numpy(lens))
    np.testing.assert_allclose(out[:, :12].numpy(), base[:, :12].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not np.allclose(out[:, 12:].numpy(), base[:, 12:].numpy())


@pytest.mark.parametrize("offset", [0, 7, 4990, 6000])
def test_positional_offset_clamps_like_dynamic_slice(offset):
    x = np.random.RandomState(0).randn(1, 20, 16).astype(np.float32)
    table = jnp.asarray(sinusoid_table(5000, 16))
    want = x + np.asarray(jax.lax.dynamic_slice_in_dim(table, offset, 20, axis=0))[None]
    got = PositionalEncoding(16)(torch.from_numpy(x), offset)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


# -- the incremental pipeline --------------------------------------------------


@pytest.fixture(scope="module")
def stream_parts():
    """A tiny causal-band model with a CTC head and fixed CMVN, as the JAX
    test's fixture builds it, with the port's twin."""
    jvocab = JaxVocab()
    jvocab.consume_sentence("".join(chr(0x4E00 + i) for i in range(8)))
    jvocab.build()
    jfeat = JaxFeatureConfig(n_mels=20, cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0)
    cfg = stream_cfg(ctc_weight=0.3)
    cfg.build(input_dim=jfeat.feature_dim)
    jm = JaxModel(cfg, jvocab.vocab_size)
    sr = jfeat.sample_rate
    feats, feat_lens = jax_parse_batch(
        np.zeros((1, sr), np.float32), np.asarray([sr], np.int32), jfeat
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


SEGMENTS = {
    "noise": lambda: (np.random.RandomState(3).randn(21700) * 3000).astype(np.int16),
    # loud to the last sample: the segment ends mid-speech
    "midspeech-cut": lambda: (np.sin(2 * np.pi * 523.0 * np.arange(21700) / 16000)
                              * 12000).astype(np.int16),
}


@pytest.mark.parametrize("seg_name", list(SEGMENTS))
def test_incremental_pipeline_matches_offline_and_jax(stream_parts, seg_name):
    """Accumulated chunked featurize + encode == the offline encode of the
    bucketed wave, down to the LFR tail clip; encoder output and CTC argmax
    ids == JAX's pipeline."""
    jm, params, jvocab, jfeat, tm, vocab, feat = stream_parts
    kw = dict(incremental="on", chunk_frames=8, bucket_seconds=(1.0, 2.0))
    rec = StreamingRecognizer(tm, vocab, feat, **kw)
    jrec = JaxRecognizer(jm, params, jvocab, jfeat, **kw)
    seg = SEGMENTS[seg_name]()
    for r in (rec, jrec):
        for i in range(4000, len(seg), 4000):
            r._inc_advance(0, seg[:i], final=False)
        assert r._inc_lfr_done > 0, "partial advances encoded nothing"
        r._inc_advance(0, seg, final=True)
    enc_inc = torch.cat(rec._inc_enc).numpy()

    wave = np.zeros((1, rec._bucket_of(len(seg))), np.int16)
    wave[0, : len(seg)] = seg
    with torch.no_grad():
        feats, feat_lens = parse_batch(torch.from_numpy(wave),
                                       torch.tensor([len(seg)], dtype=torch.int32), feat)
        enc_full, enc_lens = tm.encode(feats, feat_lens)
    t = int(enc_lens[0])
    assert enc_inc.shape[0] == t
    np.testing.assert_allclose(enc_inc, enc_full[0, :t].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(enc_inc, np.concatenate(jrec._inc_enc), rtol=2e-4, atol=2e-4)
    assert [list(x) for x in rec._inc_ids] == [list(np.asarray(x)) for x in jrec._inc_ids]
