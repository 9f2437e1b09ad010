"""Distributed decode (``asr_chinese_e2e_tpu_torch/decode/distributed.py``)
on two gloo processes against the JAX package's
(``asr_chinese_e2e_tpu/decode/distributed.py`` on the virtual 8-device
mesh): the data-parallel beam search (tokens and finished flags identical,
scores within 1e-5, both from the same encoder output), its fallback on a
batch that does not divide, the score exchange and the distributed
rescoring; and a data-parallel ``main.train`` with ``eval_decode="beam"``,
whose decoded CER equals one process's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from asr_chinese_e2e_tpu.decode.distributed import (
    distributed_beam_search as jax_distributed_beam_search,
    exchange_scores as jax_exchange_scores,
    make_sharded_rescorer as jax_make_sharded_rescorer,
)
from asr_chinese_e2e_tpu.parallel.sharding import make_mesh as jax_make_mesh
from asr_chinese_e2e_tpu_torch.parallel import dryrun
from tests import torch_parallel_cases as cases
from tests.test_torch_model import model_pair, tiny_config

VOCAB = 23
BEAM, MAX_LEN = 4, 8


@pytest.fixture(scope="module")
def jax_side():
    jcfg = tiny_config()
    jm, params, _ = model_pair(jcfg, vocab_size=VOCAB, seed=1)
    rng = np.random.RandomState(0)
    feats = rng.randn(8, 14, 24).astype(np.float32)
    lens = np.asarray([14, 9, 11, 14, 7, 12, 10, 13], np.int32)
    enc, enc_lens = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens), method="encode")
    enc, enc_lens = np.asarray(enc), np.asarray(enc_lens)
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    encs = {"divisible": (enc, enc_lens), "indivisible": (enc[:3], enc_lens[:3])}
    results = {
        name: jax_distributed_beam_search(
            jm, params, jnp.asarray(e), jnp.asarray(el), BEAM, MAX_LEN, mesh).materialize()
        for name, (e, el) in encs.items()
    }
    from asr_chinese_e2e_tpu_torch.core.config import Config
    from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax

    state = torch_state_from_flax(params, Config(**jcfg.to_dict()), VOCAB)
    return {"cfg": jcfg.to_dict(), "state": state, "enc": encs, "results": results}


SCORES = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
RESCORE = np.random.RandomState(1).randn(2, 8, 5).astype(np.float32)
LAM = 0.3


@pytest.fixture(scope="module")
def port_side(jax_side):
    payload = {"cfg": jax_side["cfg"], "state": jax_side["state"], "vocab": VOCAB,
               "enc": jax_side["enc"], "beam": BEAM, "max_len": MAX_LEN,
               "scores": SCORES, "ctc": RESCORE[0], "att": RESCORE[1], "lam": LAM}
    return dryrun.run_ranks(2, cases.decode_cases, payload)


def _same_nbest(got, want):
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.finished, np.asarray(want.finished))


def test_distributed_beam_matches_jax(jax_side, port_side):
    """8 rows over data 2: every rank holds the global n-best, JAX's."""
    for rank in port_side:
        _same_nbest(rank["divisible"], jax_side["results"]["divisible"])


def test_distributed_beam_on_rows_already_split(jax_side, port_side):
    """``local_rows``: each rank gives only its rows (as ``recognize`` and
    the trainer do after encoding them); the same global n-best."""
    for rank in port_side:
        _same_nbest(rank["local_rows"], jax_side["results"]["divisible"])


def test_indivisible_batch_falls_back(jax_side, port_side):
    """3 rows do not divide data 2: the whole batch on every rank, as JAX's
    fallback to its unsharded beam."""
    for rank in port_side:
        assert rank["indivisible"].tokens.shape[0] == 3
        _same_nbest(rank["indivisible"], jax_side["results"]["indivisible"])


def test_exchange_scores_assembles_the_global_tile(port_side):
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    want = shard_map(lambda s: jax_exchange_scores(s, "data"), mesh=mesh,
                     in_specs=(P("data"),), out_specs=P(), check_vma=False)(SCORES)
    for rank in port_side:
        np.testing.assert_array_equal(rank["exchange"].numpy(), np.asarray(want))
        np.testing.assert_array_equal(rank["exchange"].numpy(), SCORES)


def test_distributed_rescore_matches_jax(port_side):
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    want_scores, want_best = jax_make_sharded_rescorer(mesh)(
        jnp.asarray(RESCORE[0]), jnp.asarray(RESCORE[1]), jnp.float32(LAM))
    for rank in port_side:
        for key in ("rescore", "rescorer"):
            scores, best = rank[key]
            np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-6)
            np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))


# -- eval_decode="beam" under a data mesh -------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus

    return make_synth_corpus(
        str(tmp_path_factory.mktemp("dist_corpus")), n_train=8, n_dev=4, n_test=0,
        n_tone_chars=6, vocab_size=30, seconds_range=(0.6, 0.8), tone_sec=0.2, seed=5)


def _train_kwargs(corpus, exp_root, name, **extra):
    return dict(
        vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest="", device="cpu", use_native_io=False,
        n_mels=20, d_model=32, num_heads=2, head_dim=16, d_ff=64, num_encoder_layers=1,
        num_decoder_layers=1, batch_size=4, num_epoch=1, log_every_iter=1,
        eval_every_iter=0, save_every_iter=0, lr_schedule="constant", lr=1e-3,
        dropout_rate=0.0, eval_decode="beam", eval_beam_size=2, max_target_len=8,
        exp_root=exp_root, exp_name=name, **extra)


def test_eval_decode_beam_under_a_data_mesh(corpus, tmp_path):
    """``main.train`` over two processes (``mesh_data`` -1 takes both) with
    ``eval_decode="beam"``: the dev rows (loss, teacher-forced and decoded
    CER) equal one process's run of the same global batches."""
    from asr_chinese_e2e_tpu_torch.main import train

    kw = _train_kwargs(corpus, str(tmp_path), "dp")
    ranks = dryrun.run_ranks(2, cases.trainer_case, {"kwargs": kw})
    one = train(**_train_kwargs(corpus, str(tmp_path), "single"))
    import json
    import os

    with open(os.path.join(one.exp_dir, "scalars.jsonl")) as f:
        single = [json.loads(line) for line in f]

    def dev(rows):
        return [{k: v for k, v in r.items() if k.startswith("dev/")} for r in rows
                if "dev/decoded_cer" in r]

    want = dev(single)
    assert want and all(np.isfinite(r["dev/decoded_cer"]) for r in want)
    for rank in ranks:
        assert rank["mesh"] == {"data": 2, "model": 1, "seq": 1} and rank["n_chips"] == 2
        got = dev(rank["rows"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
