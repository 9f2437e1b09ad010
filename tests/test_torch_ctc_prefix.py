"""The port's CTC prefix beam searches and attention rescoring against the
JAX package's, on numpy-seeded log-probs and converted weights:

- ``ctc_prefix_beam_search`` / ``ctc_prefix_beam_batch`` (host, numpy):
  outputs equal to JAX's;
- ``ctc_prefix_beam_device`` with ragged lengths, duplicate merging and the
  merge-before-select fold: identical prefixes and lengths, scores 1e-5;
  ``_merge_duplicates`` on a state with duplicates and dead slots, and
  ``device_nbest_to_lists``, the same;
- ``attention_rescore`` on a tiny 2+2-layer model (vocabulary 20):
  identical best ids, and its teacher-forced scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode import ctc_prefix as jax_prefix
from asr_chinese_e2e_tpu.decode import ctc_prefix_device as jax_device
from asr_chinese_e2e_tpu_torch.decode import ctc_prefix, ctc_prefix_device
from tests.test_torch_model import model_pair, tiny_config

torch.set_num_threads(2)

VOCAB = 20


def peaky_log_probs(seed, b=3, t=25, c=12, sharpness=3.0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, c).astype(np.float32) * sharpness
    return np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))


@pytest.mark.parametrize("seed,sharpness,beam", [(0, 3.0, 8), (1, 1.0, 4), (2, 0.5, 10)])
def test_host_prefix_beam_equals_jax(seed, sharpness, beam):
    lp = peaky_log_probs(seed, sharpness=sharpness)
    lens = np.asarray([25, 18, 7])
    for b in range(3):
        got = ctc_prefix.ctc_prefix_beam_search(lp[b], int(lens[b]), beam)
        assert got == jax_prefix.ctc_prefix_beam_search(lp[b], int(lens[b]), beam)
    assert ctc_prefix.ctc_prefix_beam_batch(lp, lens, beam) == (
        jax_prefix.ctc_prefix_beam_batch(lp, lens, beam))


DEVICE_CASES = {
    "peaky": dict(seed=0, sharpness=3.0, beam=8, prune=16, lens=[25, 20, 15]),
    "flat": dict(seed=1, sharpness=1.0, beam=8, prune=10, lens=[25, 25, 25]),
    "tiny-vocab-merges": dict(seed=3, sharpness=0.7, c=4, beam=6, prune=4, lens=[25, 9, 17]),
    "short-prefix-cap": dict(seed=4, sharpness=2.0, beam=5, prune=6, lens=[25, 3, 12],
                             max_prefix_len=4),
}


@pytest.mark.parametrize("name", list(DEVICE_CASES))
def test_device_prefix_beam_matches_jax(name):
    case = dict(DEVICE_CASES[name])
    lens = np.asarray(case.pop("lens"), np.int32)
    lp = peaky_log_probs(case.pop("seed"), c=case.pop("c", 12), sharpness=case.pop("sharpness"))
    kw = dict(beam_size=case.pop("beam"), prune=case.pop("prune"), **case)
    want = [np.asarray(x) for x in
            jax_device.ctc_prefix_beam_device(jnp.asarray(lp), jnp.asarray(lens), **kw)]
    got = [x.numpy() for x in ctc_prefix_device.ctc_prefix_beam_device(
        torch.from_numpy(lp), torch.from_numpy(lens), **kw)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    lists = ctc_prefix_device.device_nbest_to_lists(*got)
    want_lists = jax_device.device_nbest_to_lists(*want)
    assert [[h for h, _ in u] for u in lists] == [[h for h, _ in u] for u in want_lists]
    assert lists[0][0][0]  # a non-empty best prefix


def test_merge_duplicates_matches_jax():
    rng = np.random.RandomState(5)
    prefixes = np.zeros((2, 5, 4), np.int32)
    prefixes[0] = [[3, 4, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0], [3, 4, 0, 0], [3, 4, 9, 0]]
    prefixes[1] = [[1, 0, 0, 0], [2, 0, 0, 0], [1, 7, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0]]
    plen = np.asarray([[2, 2, 1, 2, 3], [1, 1, 2, 1, 0]], np.int32)
    last = np.asarray([[4, 4, 5, 4, 9], [1, 2, 7, 2, -1]], np.int32)
    pb = rng.randn(2, 5).astype(np.float32) - 3
    pnb = rng.randn(2, 5).astype(np.float32) - 3
    pb[0, 3] = pnb[0, 3] = -1e30  # a dead duplicate stays out of the fold
    args = (prefixes, plen, last, pb, pnb)
    want = jax_device._merge_duplicates(*(jnp.asarray(a) for a in args))
    got = ctc_prefix_device._merge_duplicates(*(torch.from_numpy(a).clone() for a in args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert (got[3][0, 1] == -1e30).item() and (got[3][1, 3] == -1e30).item()


@pytest.fixture(scope="module")
def rescore_parts():
    jm, params, tm = model_pair(tiny_config(), vocab_size=VOCAB, seed=4)
    rng = np.random.RandomState(6)
    feats = rng.randn(3, 14, 24).astype(np.float32)
    lens = np.asarray([14, 9, 11], np.int32)
    j_enc, j_len = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens), method="encode")
    with torch.no_grad():
        t_enc, t_len = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    return jm, params, tm, j_enc, j_len, t_enc, t_len


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3, 1.0])
def test_attention_rescore_matches_jax(rescore_parts, ctc_weight):
    jm, params, tm, j_enc, j_len, t_enc, t_len = rescore_parts
    lp = jm.apply(params, j_enc, method="ctc_log_probs")
    nbest = jax_device.device_nbest_to_lists(
        *jax_device.ctc_prefix_beam_device(lp, j_len, beam_size=4, prune=6))
    nbest[1].append((tuple(), -3.0))  # an empty hypothesis among them
    want = jax_prefix.attention_rescore(jm, params, j_enc, j_len, nbest, ctc_weight)
    got = ctc_prefix.attention_rescore(tm, t_enc, t_len, nbest, ctc_weight)
    assert got == want
    assert ctc_prefix.attention_rescore(tm, t_enc, t_len, [[], [], []]) == [[], [], []]


def test_rescore_scores_match_jax(rescore_parts):
    jm, params, tm, j_enc, j_len, t_enc, t_len = rescore_parts
    labels = np.asarray([[4, 5, 6, 0], [7, 0, 0, 0], [8, 9, 4, 11]], np.int32)
    label_lens = np.asarray([3, 1, 4], np.int32)
    want = jax_prefix._rescore_scores(jm, params, jnp.asarray(labels), jnp.asarray(label_lens),
                                      j_enc, j_len)
    got = ctc_prefix._rescore_scores(tm, torch.from_numpy(labels).long(),
                                     torch.from_numpy(label_lens).long(), t_enc, t_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
