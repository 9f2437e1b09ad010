"""The port's RNN family (``models/rnn.py``: BiLSTMCTC, LAS) against the
JAX package's, on the CPU: numpy-seeded inputs, flax-converted weights,
f32 throughout, tolerances stated per test. The registry, flax's
flip-within-length and cell layout, the forwards, LAS's ``decode_step``,
the searches over the LAS carry (greedy, beam, joint), and the beam
reorder's gather of tuple leaves (an LSTM carry is a (c, h) tuple).
Training, ``main.train``, ``recognize`` and streaming with these models
are in ``tests/test_torch_rnn_train.py``."""


import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode.beam import beam_search as jax_beam_search
from asr_chinese_e2e_tpu.decode.greedy import attention_greedy_decode as jax_greedy
from asr_chinese_e2e_tpu.decode.joint import joint_beam_search as jax_joint
from asr_chinese_e2e_tpu.models.example import ExampleModel as JaxExample
from asr_chinese_e2e_tpu.models.example import default_config as jax_example_config
from asr_chinese_e2e_tpu.models.rnn import LAS as JaxLAS
from asr_chinese_e2e_tpu.models.rnn import BiLSTMCTC as JaxBiLSTMCTC
from asr_chinese_e2e_tpu.models.rnn import BiLSTMEncoder as JaxEncoder
from asr_chinese_e2e_tpu.models.rnn import default_ctc_config, default_las_config
from asr_chinese_e2e_tpu.core.registry import available_models as jax_available_models
from asr_chinese_e2e_tpu.core.registry import get_model as jax_get_model
from asr_chinese_e2e_tpu.models.transformer import preprocess_targets as jax_preprocess
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.core.registry import available_models, get_model
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search, make_gather_carry
from asr_chinese_e2e_tpu_torch.decode.greedy import attention_greedy_decode, tokens_to_ids
from asr_chinese_e2e_tpu_torch.decode.joint import joint_beam_search
from asr_chinese_e2e_tpu_torch.models import example as port_example
from asr_chinese_e2e_tpu_torch.models import rnn as port_rnn
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.rnn import LAS, BiLSTMCTC, flip_index

torch.set_num_threads(2)

VOCAB = 19
ARGS = ("wave", "wave_lengths", "labels", "label_lengths")
JAX_CLASSES = {"BiLSTMCTC": JaxBiLSTMCTC, "LAS": JaxLAS, "ExampleModel": JaxExample}
PORT_CLASSES = {"BiLSTMCTC": BiLSTMCTC, "LAS": LAS,
                "ExampleModel": port_example.ExampleModel}


def ctc_cfg(**kw):
    return default_ctc_config().build(hidden_size=12, input_dim=10, dropout_rate=0.0, **kw)


def las_cfg(**kw):
    base = dict(hidden_size=16, embed_dim=12, attention_dim=12, input_dim=10,
                num_encoder_layers=2, dropout_rate=0.0, location_kernel=6,
                location_filters=4)
    return default_las_config().build(**{**base, **kw})


def example_cfg(**kw):
    return jax_example_config().build(hidden_size=24, input_dim=10, **kw)


CFGS = {"BiLSTMCTC": ctc_cfg, "LAS": las_cfg, "ExampleModel": example_cfg}


def batch(b=3, t=11, l=5, input_dim=10, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, input_dim).astype(np.float32)
    lens = np.asarray([t, t - 4, t - 1, 5][:b], np.int32)
    label_lens = np.asarray([l, l - 2, l - 1, 2][:b], np.int32)
    labels = rng.randint(4, VOCAB, size=(b, l)).astype(np.int32)
    labels *= np.arange(l)[None, :] < label_lens[:, None]
    return {"wave": feats, "wave_lengths": lens, "labels": labels,
            "label_lengths": label_lens}


def pair(name, cfg, seed=0):
    """(flax module, its params as numpy, the port model with them)."""
    jm = JAX_CLASSES[name](cfg, VOCAB)
    b = batch(b=1)
    params = jm.init(jax.random.PRNGKey(seed), *(jnp.asarray(b[k]) for k in ARGS))
    params = jax.tree.map(np.asarray, params)
    pcfg = Config(**cfg.to_dict())
    tm = PORT_CLASSES[name](pcfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, pcfg, VOCAB))
    return jm, params, tm.eval()


def _t(b):
    return [torch.from_numpy(b[k]) for k in ARGS]


def _valid(lens, t):
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


# -- the modules ---------------------------------------------------------------


def test_registry_returns_port_modules():
    assert get_model("BiLSTMCTC") == (BiLSTMCTC, port_rnn.default_ctc_config)
    assert get_model("LAS") == (LAS, port_rnn.default_las_config)
    assert get_model("ExampleModel")[0] is port_example.ExampleModel
    for name, jax_default in (("BiLSTMCTC", default_ctc_config),
                              ("LAS", default_las_config),
                              ("ExampleModel", jax_example_config)):
        assert get_model(name)[1]().to_dict() == jax_default().to_dict()


def test_registry_contract():
    """The counterpart of ``tests/test_rnn_models.py::test_registry_contract``:
    the JAX registry's names, sorted, with the reference alias among them."""
    names = available_models()
    assert names == jax_available_models() == sorted(names)
    for required in ["SpeechTransformer", "TransformerOffical", "BiLSTMCTC", "LAS",
                     "ExampleModel"]:
        assert required in names
    cls, cfg_fn = get_model("BiLSTMCTC")
    assert cls is BiLSTMCTC and "hidden_size" in cfg_fn()
    with pytest.raises(KeyError, match="available"):
        get_model("NoSuchModel")


@pytest.mark.parametrize("name", jax_available_models())
def test_every_registry_name_has_the_jax_class_and_defaults(name):
    cls, cfg_fn = get_model(name)
    jax_cls, jax_cfg_fn = jax_get_model(name)
    assert cls.__name__ == jax_cls.__name__
    assert cls.__module__.startswith("asr_chinese_e2e_tpu_torch.")
    assert cfg_fn().to_dict() == jax_cfg_fn().to_dict()


def test_flip_index_is_flax_flip_sequences():
    from flax.linen.recurrent import flip_sequences

    x = np.arange(3 * 7, dtype=np.float32).reshape(3, 7, 1)
    lens = np.asarray([7, 4, 1])
    want = np.asarray(flip_sequences(jnp.asarray(x), jnp.asarray(lens), 1, False))
    idx = flip_index(torch.from_numpy(lens), 7)
    got = torch.from_numpy(x).gather(1, idx[..., None]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(idx.gather(1, idx).numpy(), np.tile(np.arange(7), (3, 1)))


def test_lstm_cell_mapping_one_cell():
    """One flax OptimizedLSTMCell step against torch's LSTMCell with the
    converted weights: the eight kernels land in the packed (i, f, g, o)
    rows, the hidden bias in bias_hh; flax's carry (c, h), torch's (h, c)."""
    import flax.linen as fnn

    from asr_chinese_e2e_tpu_torch.models.convert import _lstm

    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32)
    c0, h0 = rng.randn(2, 4, 5).astype(np.float32)
    cell = fnn.OptimizedLSTMCell(5)
    params = cell.init(jax.random.PRNGKey(2), (jnp.asarray(c0), jnp.asarray(h0)), x)["params"]
    # a bias that is not zero, so its place is tested too
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape), params)
    (c1, h1), y = cell.apply({"params": params}, (jnp.asarray(c0), jnp.asarray(h0)),
                             jnp.asarray(x))
    sd = {}
    _lstm(params, sd, "cell")
    tc = torch.nn.LSTMCell(6, 5)
    tc.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    h, c = tc(torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h1), atol=1e-6)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(c1), atol=1e-6)
    np.testing.assert_allclose(np.asarray(y), np.asarray(h1))


def test_encoder_cell_order_is_forward_then_backward():
    """flax names layer i's cells OptimizedLSTMCell_{2i} and _{2i+1}: run a
    one-layer flax encoder and each flax cell alone by hand; cell 0 makes
    the first (forward) half of the output, cell 1 the second (backward,
    within each length)."""
    cfg = ctc_cfg(num_encoder_layers=1)
    enc = JaxEncoder(cfg)
    b = batch()
    x, lens = jnp.asarray(b["wave"]), jnp.asarray(b["wave_lengths"])
    params = enc.init(jax.random.PRNGKey(0), x, lens)
    out, _ = enc.apply(params, x, lens)
    out = np.asarray(out)
    import flax.linen as fnn

    step = jax.jit(fnn.OptimizedLSTMCell(cfg.hidden_size).apply)

    def run_cell(p, seq):
        carry = (jnp.zeros((seq.shape[0], cfg.hidden_size)),) * 2
        ys = []
        for t in range(seq.shape[1]):
            carry, y = step({"params": p}, carry, seq[:, t])
            ys.append(np.asarray(y))
        return np.stack(ys, 1)

    p = params["params"]
    valid = _valid(b["wave_lengths"], x.shape[1])
    fwd = run_cell(p["OptimizedLSTMCell_0"], x)
    np.testing.assert_allclose(out[..., :cfg.hidden_size][valid], fwd[valid], atol=1e-6)
    for i, n in enumerate(b["wave_lengths"]):
        bwd = run_cell(p["OptimizedLSTMCell_1"], x[i:i + 1, :n][:, ::-1])[0, ::-1]
        np.testing.assert_allclose(out[i, :n, cfg.hidden_size:], bwd, atol=1e-6)


@pytest.mark.parametrize("layers", [1, 2])
def test_bilstm_ctc_forward_matches_jax(layers):
    """Encoder output and CTC logits on ragged lengths, valid rows within
    1e-5; padded rows of the encoder are zero on both sides."""
    jm, params, tm = pair("BiLSTMCTC", ctc_cfg(num_encoder_layers=layers))
    b = batch()
    jout = jax.jit(jm.apply)(params, *(jnp.asarray(b[k]) for k in ARGS))
    with torch.no_grad():
        tout = tm(*_t(b))
    assert set(tout) == set(jout) == {"ctc_logits", "enc_out", "enc_lengths"}
    valid = _valid(b["wave_lengths"], b["wave"].shape[1])
    for key in ("enc_out", "ctc_logits"):
        np.testing.assert_allclose(tout[key].numpy()[valid], np.asarray(jout[key])[valid],
                                   atol=1e-5, rtol=0, err_msg=key)
    assert not tout["enc_out"].numpy()[~valid].any()
    # padded frames reach no valid output
    b2 = {**b, "wave": b["wave"].copy()}
    b2["wave"][~valid] = 50.0
    with torch.no_grad():
        t2 = tm(*_t(b2))
    np.testing.assert_array_equal(t2["ctc_logits"].numpy()[valid],
                                  tout["ctc_logits"].numpy()[valid])


def test_las_teacher_forced_and_decode_step_match_jax():
    """Teacher-forced logits, the CTC logits and ``gold`` within 1e-4 of
    JAX's; then 5 ``decode_step`` calls from ``init_decode_state`` against
    JAX's, log-probs within 1e-4, and the step path reproduces the
    teacher-forced path."""
    jm, params, tm = pair("LAS", las_cfg())
    b = batch()
    jin = [jnp.asarray(b[k]) for k in ARGS]
    jout = jax.jit(jm.apply)(params, *jin)
    with torch.no_grad():
        tout = tm(*_t(b))
    assert set(tout) == set(jout)
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-4)
    valid = _valid(b["wave_lengths"], b["wave"].shape[1])
    np.testing.assert_allclose(tout["ctc_logits"].numpy()[valid],
                               np.asarray(jout["ctc_logits"])[valid], atol=1e-5)
    np.testing.assert_array_equal(tout["gold"].numpy(), np.asarray(jout["gold"]))

    enc, enc_len = jm.apply(params, jin[0], jin[1], method="encode")
    jstate = jm.apply(params, enc, enc_len, method="init_decode_state")
    jstep = jax.jit(functools.partial(jm.apply, method="decode_step"))
    ys_in, _ = jax_preprocess(jin[2], jin[3])
    with torch.no_grad():
        tenc, tlen = tm.encode(*_t(b)[:2])
        tstate = tm.init_decode_state(tenc, tlen)
        assert isinstance(tstate["carry"]["cell"], tuple)
        tf_logp = torch.log_softmax(tout["logits"], -1).numpy()
        for i in range(5):
            jlp, jstate = jstep(params, ys_in[:, i], jstate)
            tlp, tstate = tm.decode_step(torch.from_numpy(np.asarray(ys_in[:, i])).long(),
                                         tstate, i)
            np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4, err_msg=i)
            np.testing.assert_allclose(tlp.numpy(), tf_logp[:, i], atol=1e-5, err_msg=i)
            np.testing.assert_allclose(tstate["carry"]["align"].numpy(),
                                       np.asarray(jstate["carry"]["align"]), atol=1e-5)


def test_las_without_ctc_head():
    jm, params, tm = pair("LAS", las_cfg(ctc_weight=0.0))
    b = batch()
    jout = jax.jit(jm.apply)(params, *(jnp.asarray(b[k]) for k in ARGS))
    with torch.no_grad():
        tout = tm(*_t(b))
    assert "ctc_logits" not in tout and tm.ctc_head is None
    np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]), atol=1e-4)
    with pytest.raises(ValueError, match="CTC head"):
        tm.ctc_log_probs(tout["enc_out"])


# -- searches over the LAS carry ----------------------------------------------


@pytest.fixture(scope="module")
def las_encoded():
    jm, params, tm = pair("LAS", las_cfg(), seed=3)
    b = batch(seed=4)
    jin = [jnp.asarray(b[k]) for k in ARGS]
    jenc, jlen = jm.apply(params, jin[0], jin[1], method="encode")
    with torch.no_grad():
        tenc, tlen = tm.encode(*_t(b)[:2])
    return jm, params, tm, jenc, jlen, tenc, tlen


def test_las_beam1_equals_attention_greedy(las_encoded):
    _, _, tm, _, _, tenc, tlen = las_encoded
    tokens, _ = attention_greedy_decode(tm, tenc, tlen, 6)
    res = beam_search(tm, tenc, tlen, beam_size=1, max_len=6)
    assert [h[0] for h in res.nbest_ids(1)] == tokens_to_ids(tokens)


def test_las_greedy_matches_jax(las_encoded):
    jm, params, tm, jenc, jlen, tenc, tlen = las_encoded
    jtok, jscore = jax_greedy(jm, params, jenc, jlen, 6)
    tok, score = attention_greedy_decode(tm, tenc, tlen, 6)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-5)


def test_las_beam3_matches_jax(las_encoded):
    """beam 3: ids equal to JAX's and scores within 1e-4 (the carry's
    (c, h) tuple is reordered on every reselection)."""
    jm, params, tm, jenc, jlen, tenc, tlen = las_encoded
    want = jax_beam_search(jm, params, jenc, jlen, beam_size=3, max_len=6).materialize()
    got = beam_search(tm, tenc, tlen, beam_size=3, max_len=6).materialize()
    assert got.nbest_ids(3) == want.nbest_ids(3)
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)


@pytest.mark.parametrize("ctc_weight", [0.3, 1.0])
def test_las_joint_matches_jax(las_encoded, ctc_weight):
    jm, params, tm, jenc, jlen, tenc, tlen = las_encoded
    want = jax_joint(jm, params, jenc, jlen, beam_size=3, max_len=6,
                     ctc_weight=ctc_weight, ctc_prune=5).materialize()
    got = joint_beam_search(tm, tenc, tlen, beam_size=3, max_len=6,
                            ctc_weight=ctc_weight, ctc_prune=5).materialize()
    assert got.nbest_ids(3) == want.nbest_ids(3)
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)


def test_beam_gather_reorders_tuple_leaves():
    """Every (B*K)-leading leaf of the carry is gathered by the parent map,
    tuple leaves (an LSTM's (c, h)) included."""
    bsz, k = 2, 3
    leaf = lambda: torch.arange(bsz * k, dtype=torch.float32)[:, None].repeat(1, 2)
    carry = {"cell": (leaf(), leaf()), "align": leaf(), "layers": [leaf()]}
    parent = torch.tensor([[2, 2, 0], [1, 0, 0]])
    got = make_gather_carry(bsz, k)(carry, parent)
    want = (torch.arange(bsz)[:, None] * k + parent).reshape(-1).float()
    assert isinstance(got["cell"], tuple)
    for x in (*got["cell"], got["align"], got["layers"][0]):
        assert torch.equal(x[:, 0], want)
