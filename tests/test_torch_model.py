"""The port's SpeechTransformer against the JAX model on converted weights:
encode, uncached decoder, cached decode steps (plain and lazy beam
reorder) and CTC log-probs, f32, tolerance 1e-4 abs.

The JAX side runs the fused attention kernel the way its own tests do
(Pallas interpret mode on the CPU); the port runs the kernel's plain
version, because its tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.models.transformer import default_config as jax_default_config
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer

torch.set_num_threads(2)

VOCAB = 17
TOL = 1e-4
CONFIGS = {
    "xla-post": dict(attn_impl="xla", norm_type="post"),
    "fused-post": dict(attn_impl="fused", norm_type="post"),
    "xla-pre": dict(attn_impl="xla", norm_type="pre"),
    "fused-pre": dict(attn_impl="fused", norm_type="pre"),
    "xla-deepnorm": dict(attn_impl="xla", norm_type="post", deepnorm=True),
    "fused-causal-band": dict(
        attn_impl="fused", norm_type="post", causal_encoder=True, attention_band=3
    ),
}


def tiny_config(**overrides):
    """A 2+2-layer, 32-wide SpeechTransformer config (JAX ``Config``)."""
    base = dict(
        d_model=32, num_heads=4, head_dim=8, d_ff=64, num_encoder_layers=2,
        num_decoder_layers=2, ctc_weight=0.3, input_dim=24,
    )
    base.update(overrides)
    return jax_default_config().build(**base)


def model_pair(jcfg, vocab_size=VOCAB, seed=0):
    """(jax model, flax params as numpy, port model with converted weights)."""
    jm = JaxModel(jcfg, vocab_size)
    params = jm.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, 8, jcfg.input_dim)), jnp.asarray([8]),
        jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]),
    )
    params = jax.tree.map(np.asarray, params)
    cfg = Config(**jcfg.to_dict())
    tm = SpeechTransformer(cfg, vocab_size)
    tm.load_state_dict(torch_state_from_flax(params, cfg, vocab_size))
    return jm, params, tm.eval()


_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = model_pair(tiny_config(**CONFIGS[name]))
    return _PAIRS[name]


def _inputs(seed=0, b=2, t=12, input_dim=24):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, input_dim).astype(np.float32)
    lens = np.asarray([t, t - 5], np.int32)
    return feats, lens


def _encode_both(jm, params, tm, feats, lens):
    j_enc, j_len = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        t_enc, t_len = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    return np.asarray(j_enc), np.asarray(j_len), t_enc, t_len


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_jax(name):
    jm, params, tm = _pair(name)
    feats, lens = _inputs()
    j_enc, j_len, t_enc, t_len = _encode_both(jm, params, tm, feats, lens)
    np.testing.assert_array_equal(t_len.numpy(), j_len)
    np.testing.assert_allclose(t_enc.numpy(), j_enc, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_logits_and_ctc_match_jax(name):
    jm, params, tm = _pair(name)
    feats, lens = _inputs(seed=1)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm, feats, lens)
    rng = np.random.RandomState(2)
    ys = rng.randint(0, VOCAB, size=(2, 6)).astype(np.int32)
    ys_lens = np.asarray([6, 3], np.int32)
    want = jm.apply(
        params, jnp.asarray(ys), jnp.asarray(ys_lens), jnp.asarray(j_enc),
        jnp.asarray(lens), method="decode_logits",
    )
    want_ctc = jm.apply(params, jnp.asarray(j_enc), method="ctc_log_probs")
    with torch.no_grad():
        got = tm.decode_logits(
            torch.from_numpy(ys).long(), torch.from_numpy(ys_lens), t_enc,
            torch.from_numpy(lens),
        )
        got_ctc = tm.ctc_log_probs(t_enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(got_ctc.numpy(), np.asarray(want_ctc), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["xla-post", "fused-pre", "xla-deepnorm"])
def test_decode_step_matches_jax(name):
    jm, params, tm = _pair(name)
    feats, lens = _inputs(seed=3)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm, feats, lens)
    max_len = 5
    j_state = jm.apply(
        params, jnp.asarray(j_enc), jnp.asarray(lens), max_len, 1,
        method="init_decode_state",
    )
    with torch.no_grad():
        t_state = tm.init_decode_state(t_enc, torch.from_numpy(lens), max_len, 1)
    rng = np.random.RandomState(4)
    for i in range(4):
        tok = rng.randint(0, VOCAB, size=(2,)).astype(np.int32)
        j_lp, j_state = jm.apply(
            params, jnp.asarray(tok), j_state, i, method="decode_step"
        )
        with torch.no_grad():
            t_lp, t_state = tm.decode_step(torch.from_numpy(tok).long(), t_state, i)
        np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["xla-post", "fused-pre", "xla-deepnorm"])
def test_decode_step_lazy_matches_jax(name):
    """Beam-folded cross attention (K=3 queries per utterance) and the lazy
    ancestry routing, with an arbitrary ancestry map."""
    jm, params, tm = _pair(name)
    feats, lens = _inputs(seed=5)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm, feats, lens)
    b, k, max_len = 2, 3, 5
    j_state = jm.apply(
        params, jnp.asarray(j_enc), jnp.asarray(lens), max_len, k,
        method="init_decode_state",
    )
    with torch.no_grad():
        t_state = tm.init_decode_state(t_enc, torch.from_numpy(lens), max_len, k)
    rng = np.random.RandomState(6)
    anc = rng.randint(0, k, size=(b, k, max_len)).astype(np.int32)
    for i in range(4):
        anc[:, :, i] = np.arange(k)[None]
        tok = rng.randint(0, VOCAB, size=(b * k,)).astype(np.int32)
        j_lp, j_state = jm.apply(
            params, jnp.asarray(tok), j_state, i, jnp.asarray(anc),
            method="decode_step_lazy",
        )
        with torch.no_grad():
            t_lp, t_state = tm.decode_step_lazy(
                torch.from_numpy(tok).long(), t_state, i, torch.from_numpy(anc).long()
            )
        np.testing.assert_allclose(t_lp.numpy(), np.asarray(j_lp), atol=TOL, rtol=0)
        anc = anc[:, rng.permutation(k)]  # a beam reselection


@pytest.mark.parametrize("norm_type", ["post", "pre"])
def test_flash_matches_jax_xla_on_valid_rows(norm_type):
    """``attn_impl="flash"`` runs the fused kernels (their plain version on
    the CPU) without weight dropout. The JAX package's flash path is the
    JAX library's TPU kernel, which does not run here; at dropout 0 it
    computes the xla path's function on every valid row, so the port's
    flash encoder is held to JAX's xla encoder on the valid rows (1e-5).
    Padded rows differ by construction (segment ids let a padded query see
    the padded keys) and reach no valid output."""
    jm, params, _ = model_pair(tiny_config(attn_impl="xla", norm_type=norm_type))
    cfg = Config(**tiny_config(attn_impl="flash", norm_type=norm_type).to_dict())
    tm = SpeechTransformer(cfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, cfg, VOCAB))
    feats, lens = _inputs(seed=7)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm.eval(), feats, lens)
    valid = np.arange(feats.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(t_enc.numpy()[valid], j_enc[valid], atol=1e-5, rtol=0)


def test_flash_with_a_band_takes_the_bias_path_as_jax():
    """A band or causal pattern takes the plain bias path under "flash", as
    the JAX package's does (its flash kernel has no band): the JAX flash
    model runs here then, and the port's equals it on every row."""
    jcfg = tiny_config(attn_impl="flash", causal_encoder=True, attention_band=3)
    jm, params, tm = model_pair(jcfg)
    feats, lens = _inputs(seed=8)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm, feats, lens)
    np.testing.assert_allclose(t_enc.numpy(), j_enc, atol=TOL, rtol=0)


def test_flash_keeps_the_output_dropout_only():
    """With dropout, "flash" is "fused" without the attention-weight
    dropout: the same output-dropout draws, bit for bit."""
    out = {}
    for impl, extra in (("flash", {}), ("fused", {"attn_weight_dropout": False})):
        cfg = Config(**tiny_config(attn_impl=impl, dropout_rate=0.1, dropout_impl="hash",
                                   **extra).to_dict())
        tm = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(1))
        feats, lens = _inputs(seed=9)
        with torch.no_grad():
            enc, _ = tm.encoder(torch.from_numpy(feats), torch.from_numpy(lens),
                                torch.Generator().manual_seed(2))
        out[impl] = enc
    assert torch.equal(out["flash"], out["fused"])


@pytest.mark.parametrize("overrides", [dict(attn_impl="ring")])
def test_unported_options_raise(overrides):
    """``attn_impl="ring"``, the last option the port refused, now builds:
    with no mesh (no ``seq`` axis) its encoder is the JAX ring model's
    plain masked path (tests/test_torch_ring_attention.py runs the ring)."""
    jm, params, tm = model_pair(tiny_config(**overrides))
    feats, lens = _inputs(seed=10)
    j_enc, _, t_enc, _ = _encode_both(jm, params, tm, feats, lens)
    np.testing.assert_allclose(t_enc.numpy(), j_enc, atol=TOL, rtol=0)


@pytest.mark.parametrize("overrides", [
    dict(encoder_type="transformerxl"), dict(frontend="conv1d"),
])
def test_unknown_options_raise(overrides):
    cfg = Config(**tiny_config(**overrides).to_dict())
    with pytest.raises(ValueError, match="unknown"):
        SpeechTransformer(cfg, VOCAB)


@pytest.mark.parametrize("overrides", [
    {}, dict(encoder_type="conformer", norm_type="pre", frontend="conv2d"),
])
def test_init_is_seeded_by_the_generator(overrides):
    cfg = Config(**tiny_config(**overrides).to_dict())
    a = SpeechTransformer(cfg, VOCAB, generator=torch.Generator().manual_seed(3))
    b = SpeechTransformer(cfg, VOCAB, generator=torch.Generator().manual_seed(3))
    c = SpeechTransformer(cfg, VOCAB, generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not torch.equal(sa["decoder.embed.weight"], sc["decoder.embed.weight"])
    assert all(torch.isfinite(v).all() for v in sa.values())
