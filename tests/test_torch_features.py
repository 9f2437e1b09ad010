"""The port's feature pipeline against the JAX package's ``parse_batch``.

Same waves (from a numpy seed) through both; tolerance 1e-4 abs on the
CMVN-normalised, LFR-stacked features. ``fbank_impl="pallas"`` runs the
JAX fbank kernel in Pallas interpret mode, and the port's kernel wrapper
its plain version (the tensors lie on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig, parse_batch
from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel

torch.set_num_threads(2)

TOL = 1e-4

CASES = {
    "global-xla": dict(),
    "global-pallas": dict(fbank_impl="pallas"),
    "per_dim": dict(cmvn_mode="per_dim"),
    "fixed": dict(cmvn_mode="fixed", cmvn_mean=-7.0, cmvn_std=4.5),
    "mfcc-delta": dict(feature_type="mfcc", n_mfcc=13, use_delta=True,
                       use_delta_delta=True),
    "mfcc-delta-pallas": dict(feature_type="mfcc", n_mfcc=13, use_delta=True,
                              fbank_impl="pallas"),
}


def _waves(dtype, seed=0, b=3, s=6400):
    """Speech-like test waves (a few tones plus noise) and ragged lengths."""
    rng = np.random.RandomState(seed)
    t = np.arange(s) / 16000.0
    x = sum(
        0.2 * np.sin(2 * np.pi * f * t + rng.rand()) for f in (220.0, 710.0, 1900.0)
    )[None] + 0.05 * rng.randn(b, s)
    lens = np.asarray([s, s - 1234, s // 2 + 7][:b], np.int32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    if dtype == "int16":
        return np.clip(x * 32767, -32768, 32767).astype(np.int16), lens
    return x.astype(np.float32), lens


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("case", list(CASES))
def test_parse_batch_matches_jax(case, dtype):
    kw = dict(n_mels=40, **CASES[case])
    wave, lens = _waves(dtype)
    want, want_len = jax_parse_batch(
        jnp.asarray(wave), jnp.asarray(lens), JaxFeatureConfig(**kw)
    )
    got, got_len = parse_batch(
        torch.from_numpy(wave), torch.from_numpy(lens), FeatureConfig(**kw)
    )
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_fbank_wrapper_runs_plain_version_on_cpu():
    """On a CPU tensor the kernel wrapper is the plain version, and it does
    not count as a kernel launch."""
    cfg = FeatureConfig(n_mels=80)
    wave, _ = _waves("float32", seed=1, b=2, s=4000)
    before = log_mel_spectrogram_kernel.launches
    out = log_mel_spectrogram_kernel(torch.from_numpy(wave), cfg)
    assert out.shape == (2, cfg.num_frames(4000), 80)
    assert torch.isfinite(out).all()
    assert log_mel_spectrogram_kernel.launches == before


def test_augment_is_not_ported():
    """SpecAugment is ported; its time-warp stage is not yet."""
    wave, lens = _waves("float32", b=1, s=1600)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        parse_batch(torch.from_numpy(wave), torch.from_numpy(lens),
                    FeatureConfig(num_time_warps=1), augment=True,
                    generator=torch.Generator().manual_seed(0))
