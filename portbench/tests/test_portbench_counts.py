"""The frozen counts equal the port's and ``chip_smoke.py``'s functions they
were copied from, on the cells' shapes."""

from __future__ import annotations

import pytest

from conftest import load
from portbench.counts import bounds, flops, peaks

import chip_smoke
from asr_chinese_e2e_tpu_torch import bench
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.models.transformer import default_config

CONFIGS = ("ref-transformer", "large-transformer")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("batch,seconds,label_len", [(64, 2.0, 7), (64, 6.0, 23),
                                                     (64, 10.0, 39), (8, 8.0, 20)])
def test_train_flops_equal_the_port(name, batch, seconds, label_len):
    c = load("configs", name + ".json")
    feat = FeatureConfig(**c["features"])
    cfg = default_config().build(**c["model"])
    n = int(seconds * 16000)
    want = bench.analytic_train_flops(cfg, feat, c["vocab_size"], batch, n, label_len)
    got = flops.analytic_train_flops(c["model"], c["features"], c["vocab_size"], batch, n,
                                     label_len)
    assert got == want


def test_peaks_equal_the_port():
    assert peaks.H100_SXM_BF16_PEAK == bench.H100_SXM_BF16_PEAK
    assert peaks.H100_SXM_F32_PEAK == bench.H100_SXM_F32_PEAK
    assert peaks.H100_SXM_BYTES_PER_S == bench.H100_SXM_BYTES_PER_S


@pytest.mark.parametrize("shape", [(64, 8, 334, 334, 64), (64, 4, 67, 67, 64), (1, 4, 150, 150, 64)])
def test_attention_bounds_equal_chip_smoke(shape):
    assert bounds.attention_fwd_bound(*shape) == chip_smoke.attention_fwd_bound(*shape)
    assert bounds.attention_bwd_bound(*shape) == chip_smoke.attention_bwd_bound(*shape)


@pytest.mark.parametrize("shape", [(64, 334, 4233, 79), (64, 67, 4233, 15), (8, 501, 4233, 401)])
def test_ctc_bounds_equal_chip_smoke(shape):
    assert bounds.ctc_alpha_bound(*shape) == chip_smoke.ctc_alpha_bound(*shape)
    assert bounds.ctc_beta_bound(*shape) == chip_smoke.ctc_beta_bound(*shape)


@pytest.mark.parametrize("b,n", [(64, 160000), (1, 72000)])
def test_fbank_bound_equals_chip_smoke(b, n):
    assert bounds.fbank_bound(b, n) == chip_smoke.fbank_bound(b, n)


def test_prefix_beam_bound_equals_chip_smoke():
    args = ([150, 120, 60], 150, 4233, 10, 8, 64)
    assert bounds.ctc_prefix_beam_bound(*args) == chip_smoke.ctc_prefix_beam_bound(*args)


def test_decode_counts_are_positive_and_grow_with_length():
    c = load("configs", "large-transformer.json")
    m, f, v = c["model"], c["features"], c["vocab_size"]
    short = flops.encoder_flops(m, f, 32000, True, v) + flops.rescore_flops(m, f, 32000, v, 10, 8)
    long = flops.encoder_flops(m, f, 160000, True, v) + flops.rescore_flops(m, f, 160000, v, 10, 30)
    assert 0 < short < long
    assert flops.beam_flops(m, f, 64000, v, 10, 40) > flops.beam_flops(m, f, 64000, v, 10, 20)
