"""The port's feature cache: ``preprocess features`` -> the cached loader ->
training and evaluation on cached features, against the JAX package on the
CPU. The cached loader's batches equal JAX's over the same manifest; three
``make_step_fns(raw_features=True)`` steps on a cached batch match JAX's at
rtol 1e-5 (SpecAugment on in the config, skipped on cached features on both
sides); ``Trainer(raw_features=True)`` with ``eval_decode`` records the same
``decoded_cer`` as from the waves, with the same weights."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.batching import BucketedLoader as JaxLoader
from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.vocab import Vocab as JaxVocab
from asr_chinese_e2e_tpu_torch import preprocess
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.batching import BucketedLoader
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e_tpu_torch.train.trainer import Trainer
from tests.test_batching import setup_data
from tests.test_torch_model import model_pair, tiny_config
from tests.test_torch_train_step import VOCAB, _jax_run, _port_run
from tests.test_transformer import tiny_cfg

torch.set_num_threads(2)

N_MELS = 20


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("cache")
    mpath, jax_vocab = setup_data(root, n_short=6, n_long=3)
    vocab_path = str(root / "vocab.json")
    jax_vocab.save(vocab_path)
    manifest = preprocess.features(mpath, str(root / "feats"), n_mels=N_MELS,
                                   batch_size=4, device="cpu")
    return root, mpath, manifest, vocab_path


def _loaders(manifest, vocab_path, batch_size=2):
    ours = BucketedLoader(manifest, Vocab.load(vocab_path), batch_size=batch_size,
                          max_target_len=8, feat_cfg=FeatureConfig(n_mels=N_MELS),
                          prefetch=0)
    theirs = JaxLoader(manifest, JaxVocab.load(vocab_path), batch_size=batch_size,
                       max_target_len=8, feat_cfg=JaxFeatureConfig(n_mels=N_MELS),
                       prefetch=0)
    return ours, theirs


def test_cached_loader_batches_match_jax(cache):
    _, _, manifest, vocab_path = cache
    ours, theirs = _loaders(manifest, vocab_path)
    assert ours.cached_features and theirs.cached_features
    assert ours.boundaries == theirs.boundaries
    got, want = list(ours.epoch(0)), list(theirs.epoch(0))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.wave.ndim == 3 and a.wave.shape[2] == FeatureConfig(n_mels=N_MELS).feature_dim
        for field in ("wave", "wave_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert a.texts == b.texts


def test_three_cached_feature_steps_match_jax(cache):
    """Three steps on a batch of the cached loader from the converted JAX
    init, SpecAugment on in the config: losses rtol 1e-5, gradient norms
    rtol 1e-4 and every updated weight within 1e-5 of JAX's, as
    ``test_three_steps_match_jax``."""
    _, _, manifest, vocab_path = cache
    batch = next(iter(_loaders(manifest, vocab_path, batch_size=3)[0].epoch(0)))
    arrays = {k: getattr(batch, k) for k in ("wave", "wave_lengths", "labels", "label_lengths")}
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3, input_dim=batch.wave.shape[2])
    over = {"spec_augment": True}
    params, j_losses, j_norms, jstate = _jax_run(cfg, arrays, 3, over)
    tm, losses, norms, _ = _port_run(cfg, params, arrays, 3, over)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    want = torch_state_from_flax(jax.tree.map(np.asarray, jstate.params), tm.cfg, VOCAB)
    assert want.keys() == tm.state_dict().keys()
    for key, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5, err_msg=key)


def _trainer(model, manifest, vocab_path, exp_root, raw_features):
    feat_cfg = FeatureConfig(n_mels=N_MELS)
    cfg = default_train_config().combine(Config(**model.cfg.to_dict())).build(
        eval_decode="joint", eval_beam_size=3, max_target_len=8, exp_root=exp_root,
        exp_name="cached" if raw_features else "waves", spec_augment=True,
    )
    vocab = Vocab.load(vocab_path)
    loader = BucketedLoader(manifest, vocab, batch_size=3, max_target_len=8,
                            feat_cfg=feat_cfg if raw_features else None, prefetch=0,
                            use_native_io=False, drop_last=False)
    with pytest.warns(UserWarning, match="Noam peak"):
        opt = make_optimizer(model.parameters(), cfg, cfg.d_model)
    trainer = Trainer(model, opt, cfg, feat_cfg, vocab, loader, dev_loader=loader,
                      raw_features=raw_features)
    trainer.state = trainer.init_fn()
    return trainer


def test_trainer_on_cached_features_decodes_as_from_waves(cache):
    root, mpath, manifest, vocab_path = cache
    dim = FeatureConfig(n_mels=N_MELS).feature_dim
    vocab_size = Vocab.load(vocab_path).vocab_size
    _, _, model = model_pair(tiny_config(input_dim=dim), vocab_size=vocab_size)
    cers = {}
    for raw, path in ((True, manifest), (False, mpath)):
        trainer = _trainer(model, path, vocab_path, str(root / "exp"), raw)
        trainer.evaluate(trainer.dev_loader, "dev/")
        rows = open(os.path.join(trainer.exp_dir, "scalars.jsonl")).read().splitlines()
        cers[raw] = json.loads(rows[-1])["dev/decoded_cer"]
    assert cers[True] == cers[False]
