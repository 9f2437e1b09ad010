"""The port's joint CTC/attention search against the JAX package's, on
numpy-seeded inputs and converted weights (tiny 2+2-layer model,
vocabulary 20):

- ``_ctc_candidate_scores`` and the plain ``ctc_selected_registers`` (K8's
  plain version) against JAX's ``_ctc_candidate_scores`` and
  ``_ctc_selected_registers``, with ragged frame masks, empty and non-empty
  parents and candidates equal to the parent's last token: 1e-5;
- ``ctc_prefix_scores_host`` equal to JAX's;
- ``joint_beam_search`` at ctc_weight 0, 0.3 and 1.0, lazy and gather
  reorder, with and without precomputed CTC log-probs: identical tokens and
  finished flags, scores 1e-4 (the JAX search reorders lazily, which gives
  the same beams as a gather);
- the regression cases of ``tests/test_joint_decode.py``: the beam stays
  diverse at ctc_weight 0.3 and 1.0, ctc_weight 0 with an open prune is the
  attention beam, and at ctc_weight 1 a finished best hypothesis scores its
  host complete-sequence probability.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode import joint as jax_joint
from asr_chinese_e2e_tpu_torch.decode import joint
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_kernel as k8
from tests.test_torch_model import model_pair, tiny_config

torch.set_num_threads(2)

VOCAB = 20
TOL = 1e-5


def _registers_case(seed, b=3, k=4, t=9, c=7):
    """Class-major log-probs, a ragged frame mask, parent registers (some
    log-zero), tokens (some equal to the parent's last) and candidates."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c)
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    flat = np.ascontiguousarray(lp.transpose(0, 2, 1).reshape(b * c, t))
    lens = np.asarray([t, t - 3, 2][:b])
    mask = np.arange(t)[None, :] < lens[:, None]
    r_nb = (rng.randn(b, k, t) * 2 - 6).astype(np.float32)
    r_nb[:, 0, :3] = k8.LOG_ZERO
    r_b = (rng.randn(b, k, t) * 2 - 6).astype(np.float32)
    token = rng.randint(1, c, (b, k))
    last = rng.randint(1, c, (b, k))
    last[:, ::2] = token[:, ::2]
    cand = rng.randint(1, c, (b, k, 5))
    cand[:, :, 0] = last
    return flat, mask, r_nb, r_b, token, last, cand


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("empty", ["all", "none", "rows"])
def test_candidate_scores_match_jax(seed, empty):
    flat, mask, r_nb, r_b, _, last, cand = _registers_case(seed)
    is_empty = {"all": np.ones, "none": np.zeros}.get(
        empty, lambda s, d: np.random.RandomState(seed).rand(*s) > 0.5)(last.shape, bool)
    want = jax_joint._ctc_candidate_scores(
        jnp.asarray(flat), jnp.asarray(mask), jnp.asarray(r_nb), jnp.asarray(r_b),
        jnp.asarray(cand, jnp.int32), jnp.asarray(last, jnp.int32), jnp.asarray(is_empty))
    got = joint._ctc_candidate_scores(
        torch.from_numpy(flat), torch.from_numpy(mask), torch.from_numpy(r_nb),
        torch.from_numpy(r_b), torch.from_numpy(cand), torch.from_numpy(last),
        torch.from_numpy(is_empty))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("empty", [True, False, "rows"])
def test_selected_registers_plain_matches_jax(seed, empty):
    flat, mask, r_nb, r_b, token, last, _ = _registers_case(seed)
    if empty == "rows":
        is_empty = np.random.RandomState(seed).rand(*token.shape) > 0.5
        j_empty, t_empty = jnp.asarray(is_empty), torch.from_numpy(is_empty)
    else:
        j_empty, t_empty = jnp.asarray(empty), empty
    want = jax_joint._ctc_selected_registers(
        jnp.asarray(flat), jnp.asarray(mask), jnp.asarray(r_nb), jnp.asarray(r_b),
        jnp.asarray(token, jnp.int32), jnp.asarray(last, jnp.int32), j_empty)
    got = k8.ctc_selected_registers(
        torch.from_numpy(flat), torch.from_numpy(mask), torch.from_numpy(r_nb),
        torch.from_numpy(r_b), torch.from_numpy(token), torch.from_numpy(last), t_empty)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r_nb.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=TOL, atol=TOL)
    assert k8.ctc_selected_registers_kernel.launches == 0  # CPU: the plain version


def test_selected_registers_refuse_other_devices():
    flat, mask, r_nb, r_b, token, last, _ = _registers_case(0)
    args = [torch.from_numpy(a).to("meta") for a in (flat, mask, r_nb, r_b, token, last)]
    with pytest.raises(ValueError, match="unsupported device"):
        k8.ctc_selected_registers(*args, True)


def test_host_prefix_scores_equal_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(7, 6)
    xs = x - np.log(np.exp(x).sum(-1, keepdims=True))
    for prefix in ([], [2], [2, 2], [3, 1, 4]):
        got = joint.ctc_prefix_scores_host(xs, prefix, [1, 2, 3, 4, 5])
        want = jax_joint.ctc_prefix_scores_host(xs, prefix, [1, 2, 3, 4, 5])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def search_parts():
    """The tiny model pair and one encoder output on each side (3
    utterances of 14, 9 and 11 frames)."""
    jm, params, tm = model_pair(tiny_config(), vocab_size=VOCAB, seed=1)
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 14, 24).astype(np.float32)
    lens = np.asarray([14, 9, 11], np.int32)
    j_enc, j_len = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        t_enc, t_len = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    return jm, params, tm, j_enc, j_len, t_enc, t_len


SEARCH = dict(beam_size=4, max_len=8, ctc_prune=6)
_JAX_RESULTS = {}


def _jax_search(parts, ctc_weight, precomputed, **kw):
    key = (ctc_weight, precomputed, tuple(sorted(kw.items())))
    if key not in _JAX_RESULTS:
        jm, params, _, j_enc, j_len, _, _ = parts
        lp = jm.apply(params, j_enc, method="ctc_log_probs") if precomputed else None
        args = {**SEARCH, **kw}
        res = jax_joint.joint_beam_search(
            jm, params, j_enc, j_len, args.pop("beam_size"), args.pop("max_len"),
            ctc_weight=ctc_weight, ctc_log_probs=lp, **args).materialize()
        _JAX_RESULTS[key] = res
    return _JAX_RESULTS[key]


def _port_search(parts, ctc_weight, precomputed, lazy=True, **kw):
    _, _, tm, _, _, t_enc, t_len = parts
    lp = tm.ctc_log_probs(t_enc) if precomputed else None
    args = {**SEARCH, **kw}
    return joint.joint_beam_search(
        tm, t_enc, t_len, args.pop("beam_size"), args.pop("max_len"),
        ctc_weight=ctc_weight, ctc_log_probs=lp, lazy=lazy, **args).materialize()


@pytest.mark.parametrize("precomputed", [False, True])
@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("ctc_weight", [0.0, 0.3, 1.0])
def test_joint_search_matches_jax(search_parts, ctc_weight, lazy, precomputed):
    want = _jax_search(search_parts, ctc_weight, precomputed)
    got = _port_search(search_parts, ctc_weight, precomputed, lazy=lazy)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_array_equal(got.finished, np.asarray(want.finished))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), rtol=0, atol=1e-4)
    assert got.nbest_ids(2) == want.nbest_ids(2)


@pytest.mark.parametrize("ctc_weight", [0.3, 1.0])
def test_joint_beam_stays_diverse(search_parts, ctc_weight):
    """Finished hypotheses do not duplicate across slots, and at
    ctc_weight=1 the dead-slot sentinel survives (JAX's regression case:
    beam 4, 10 steps, prune 8)."""
    kw = dict(beam_size=4, max_len=10, ctc_prune=8)
    got = _port_search(search_parts, ctc_weight, False, **kw)
    want = _jax_search(search_parts, ctc_weight, False, **kw)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    for b in range(got.tokens.shape[0]):
        uniq = {tuple(int(t) for t in row) for row in got.tokens[b]}
        assert len(uniq) == got.tokens.shape[1] > 1, got.tokens[b]


def test_joint_weight0_open_prune_is_the_attention_beam(search_parts):
    _, _, tm, _, _, t_enc, t_len = search_parts
    a = beam_search(tm, t_enc, t_len, 3, 6).materialize()
    j = joint.joint_beam_search(tm, t_enc, t_len, 3, 6, ctc_weight=0.0,
                                ctc_prune=VOCAB).materialize()
    np.testing.assert_array_equal(a.tokens, j.tokens)
    np.testing.assert_allclose(a.scores, j.scores, rtol=1e-4, atol=1e-4)


def test_joint_weight1_scores_the_complete_sequence(search_parts):
    _, _, tm, _, _, t_enc, t_len = search_parts
    lp = tm.ctc_log_probs(t_enc).detach().double().numpy()
    j = joint.joint_beam_search(tm, t_enc, t_len, 3, 16, ctc_weight=1.0,
                                ctc_prune=VOCAB).materialize()
    a = beam_search(tm, t_enc, t_len, 3, 16).materialize()

    def complete(b, ids):
        xs = lp[b, : int(t_len[b])]
        return joint.ctc_prefix_scores_host(xs, list(ids), [1])[3]

    for b in range(t_enc.shape[0]):
        best = j.nbest_ids(1)[b][0]
        assert complete(b, best) >= complete(b, a.nbest_ids(1)[b][0]) - 1e-6
        assert j.finished[b, 0]
        np.testing.assert_allclose(j.scores[b, 0], complete(b, best), rtol=1e-4, atol=1e-4)
