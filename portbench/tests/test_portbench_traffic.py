"""The traffic generator repeats per seed, gives every seed the same set of
sizes, and hits the mixes' stated length statistics."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import load
from portbench import generate

CPU = torch.device("cpu")


def _train_mix(**kw):
    m = load("traffic", "aishell-train.json")
    m.update(kw)
    return m


def test_durations_hit_the_stated_mean_and_range():
    for name in ("aishell-train", "aishell-train-fill", "offline-beam-fill", "online-rescore"):
        m = load("traffic", name + ".json")
        d = generate.durations(m, 4000)
        assert abs(np.mean(d) - m["duration"]["mean_s"]) < 0.05
        assert min(d) >= m["duration"]["min_s"] and max(d) <= m["duration"]["max_s"]


def test_train_pool_repeats_per_seed_and_keeps_its_sizes():
    m = _train_mix(batch=8, pool_batches=12)
    a = generate.train_pool(m, 2**31 + 11, CPU)
    b = generate.train_pool(m, 2**31 + 11, CPU)
    c = generate.train_pool(m, 5, CPU)
    assert len(a) == len(b) == len(c) == 12
    for x, y in zip(a, b):
        for k in ("wave", "wave_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(x[k], y[k])
    # another seed: other waves and order, the same shapes and the same audio in all
    assert sorted(x["wave"].shape for x in a) == sorted(x["wave"].shape for x in c)
    assert sum(x["audio_s"] for x in a) == pytest.approx(sum(x["audio_s"] for x in c))
    assert any(not np.array_equal(x["wave"], y["wave"]) for x, y in zip(a, c))


def test_train_pool_buckets_like_the_loader():
    m = _train_mix(batch=16, pool_batches=48)
    pool = generate.train_pool(m, 3, CPU)
    widths = {x["wave"].shape[1] for x in pool}
    assert widths == {int(s * 16000) for s in m["bucket_seconds"]}
    for x in pool:
        w = x["wave"].shape[1]
        lo = max([0] + [int(s * 16000) for s in m["bucket_seconds"] if int(s * 16000) < w])
        assert (x["wave_lengths"] > lo).all() and (x["wave_lengths"] <= w).all()
        assert (x["wave"][np.arange(w)[None, :] >= x["wave_lengths"][:, None]] == 0).all()
        lab = x["labels"]
        assert lab.shape[1] == generate.round_label_pad(int(x["label_lengths"].max()))
        assert ((lab >= 4) & (lab < 4233) | (lab == 0)).all()
    secs = np.concatenate([x["wave_lengths"] for x in pool]) / 16000
    toks = np.concatenate([x["label_lengths"] for x in pool])
    assert abs(toks.sum() / secs.sum() - m["chars_per_s"]) < 0.05
    assert abs(secs.mean() - m["duration"]["mean_s"]) < 0.1


def test_train_pool_fills_each_batch_to_its_padded_seconds():
    m = load("traffic", "aishell-train-fill.json")
    m.update(batch_seconds=m["batch_seconds"] // 64)
    a = generate.train_pool(m, 2**31 + 17, CPU)
    c = generate.train_pool(m, 17, CPU)
    assert len(a) == len(c) == m["pool_batches"]
    for x in a:
        rows, width = x["wave"].shape
        assert rows == int(m["batch_seconds"] // (width / 16000))
    assert sorted(x["wave"].shape for x in a) == sorted(x["wave"].shape for x in c)
    # a bucket's batches in proportion to its clips over its clips a batch
    widths = [x["wave"].shape[1] for x in a]
    assert widths.count(6 * 16000) > widths.count(8 * 16000) > widths.count(10 * 16000) > 0


def test_decode_clips_repeat_per_seed_with_one_set_of_lengths():
    m = load("traffic", "online-rescore.json")
    a = generate.clips(m, 9, CPU)
    b = generate.clips(m, 9, CPU)
    c = generate.clips(m, 10, CPU)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(len(x) for x in a) == sorted(len(x) for x in c)
    assert [len(x) for x in a] != [len(x) for x in c]
    assert all(x.dtype == np.int16 for x in a)
    rms = np.sqrt(np.mean(np.concatenate(a).astype(np.float64) ** 2)) / 32768
    assert abs(rms - m["rms"]) < 0.005
