"""The port's beam search against the JAX package's on converted weights:
identical token ids, scores within 1e-4, finished flags equal. Beam 4 over
a 23-token vocabulary, lazy reorder on and off, with and without the GNMT
length penalty."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode.beam import beam_search as jax_beam_search
from asr_chinese_e2e_tpu_torch.decode.beam import (
    _top_k_stable,
    beam_search,
    make_gather_carry,
)
from tests.test_torch_model import model_pair, tiny_config

torch.set_num_threads(2)

VOCAB = 23
_PAIRS = {}


def _pair(norm_type):
    if norm_type not in _PAIRS:
        _PAIRS[norm_type] = model_pair(
            tiny_config(norm_type=norm_type), vocab_size=VOCAB, seed=1
        )
    return _PAIRS[norm_type]


@pytest.mark.parametrize("norm_type", ["post", "pre"])
@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_beam_search_matches_jax(lazy, length_penalty, norm_type):
    jm, params, tm = _pair(norm_type)
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 14, 24).astype(np.float32)
    lens = np.asarray([14, 9, 11], np.int32)
    j_enc, j_len = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens), method="encode")
    want = jax_beam_search(
        jm, params, j_enc, j_len, 4, 10, length_penalty, lazy=lazy
    ).materialize()
    with torch.no_grad():
        t_enc, t_len = tm.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    got = beam_search(tm, t_enc, t_len, 4, 10, length_penalty, lazy=lazy).materialize()
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.finished, np.asarray(want.finished))
    assert got.nbest_ids(2) == want.nbest_ids(2)


def test_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, 3.0, -1e9, 3.0, -1e9, -1e9, 2.0]])
    vals, idx = _top_k_stable(x, 5)
    assert idx.tolist() == [[1, 3, 6, 0, 2]]
    assert vals[0, -1].item() == -1e9


def test_gather_carry_reorders_only_beam_rows():
    gather = make_gather_carry(2, 3)
    rows = torch.arange(6)[:, None].repeat(1, 4)
    carry = {"self": [{"k": rows.clone(), "v": rows.clone()}], "other": torch.zeros(5)}
    parent = torch.tensor([[2, 2, 0], [1, 0, 0]])
    out = gather(carry, parent)
    assert out["self"][0]["k"][:, 0].tolist() == [2, 2, 0, 4, 3, 3]
    assert torch.equal(out["other"], carry["other"])
