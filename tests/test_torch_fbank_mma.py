"""CPU rehearsal of the tensor-core fbank kernel (K5,
``ops/csrc/fbank.cu``): a plain torch emulation of its arithmetic with its
rounding points, held against the plain version ``log_mel_spectrogram``
and the JAX package's ``log_mel_spectrogram_pallas`` (interpret mode) at
the features' bound, 1e-4 abs on the log-mel.

What the emulation keeps of the kernel: the wave as rows of ``hop``
samples with the reflection done by index (``ops/fbank.py::sample_rows``);
tiles of 64 frames, each scaled by the power of two that puts its largest
sample magnitude in [2^14, 2^15); re|im of a frame as the sum over the
16-row basis steps of A_c W_c (``basis_steps``, ``kernel_basis``: cos and
sin interleaved); fp16 hi + lo pieces of the samples and of the basis, three
products (hi.hi + hi.lo + lo.hi) with f32 accumulation; the power from
adjacent columns, scaled back; the mel by the non-zero taps (``mel_taps``)
in f32; log(x + 1e-20). A product of fp16 operands with f32 accumulation
is an f32 matmul of the same values (only the order of the sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.ops.fbank_pallas import log_mel_spectrogram_pallas
from asr_chinese_e2e_tpu_torch.data.features import (
    FeatureConfig,
    dft_basis,
    frame_signal,
    log_mel_spectrogram,
    mel_filterbank,
)
from asr_chinese_e2e_tpu_torch.ops import fbank

TOL = 1e-4  # the features' bound (tests/test_torch_features.py)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """As the other rehearsals: two test files side by side must not starve
    one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def split(x, dtype):
    hi = x.to(dtype)
    return hi.float(), (x - hi.float()).to(dtype).float()


def emulate(wave, cfg, dtype=torch.float16, pieces=("hh", "hl", "lh")):
    """(B, T, n_mels) log-mel as fbank_mma_kernel computes it; ``dtype``
    and ``pieces`` name the operand pieces and which of their products are
    made (the kernel: fp16, all three)."""
    bsz, s = wave.shape
    pad = cfg.n_fft // 2 if cfg.center else 0
    n_frames = (s + 2 * pad - cfg.win_length) // cfg.hop_length + 1
    n_tiles = -(-n_frames // fbank.FRAMES)
    c_max = -(-cfg.win_length // cfg.hop_length)
    rows = fbank.sample_rows(wave, cfg, n_tiles * fbank.FRAMES + c_max - 1)
    width = 16 * -(-cfg.hop_length // 16)
    rows = torch.nn.functional.pad(rows, (0, width - cfg.hop_length))
    # the per-tile power of two
    t_idx = torch.arange(n_tiles * fbank.FRAMES)
    per_tile = [rows[:, i * fbank.FRAMES : (i + 1) * fbank.FRAMES + c_max - 1].abs().amax((1, 2))
                for i in range(n_tiles)]
    _, e2 = torch.frexp(torch.stack(per_tile, 1))  # (B, tiles)
    shift = (15 - e2)[:, t_idx // fbank.FRAMES]  # (B, frames)
    # A: each frame's row slices in step order, scaled
    a = torch.cat([rows[:, c : c + len(t_idx), k0 : k0 + 16]
                   for c, k0 in fbank.basis_steps(cfg)], dim=-1)
    a = torch.ldexp(a, shift[..., None].float())
    basis = torch.from_numpy(fbank.kernel_basis(cfg))
    a_hi, a_lo = split(a, dtype)
    b_hi, b_lo = split(basis, dtype)
    parts = {"hh": (a_hi, b_hi), "hl": (a_hi, b_lo), "lh": (a_lo, b_hi)}
    acc = sum(x @ y for x, y in (parts[p] for p in pieces))
    n_freq = cfg.n_fft // 2 + 1
    power = acc[..., 0 : 2 * n_freq : 2] ** 2 + acc[..., 1 : 2 * n_freq : 2] ** 2
    power = power * torch.ldexp(torch.ones(()), -2 * shift[..., None].float())
    table, weights = fbank.mel_taps(cfg)
    weights = torch.from_numpy(weights)
    m = cfg.n_mels
    mel = torch.zeros(*power.shape[:2], m)
    for i in range(m):
        first, w0, w1 = int(table[i]), int(table[m + i]), int(table[m + i + 1])
        for j in range(w1 - w0):
            mel[..., i] = mel[..., i] + power[..., first + j] * weights[w0 + j]
    return torch.log(mel + 1e-20)[:, :n_frames]


def _waves(kind, seed=0, b=3, s=6400):
    """Random int16 (as the wire format scales them), or speech-like waves
    (tests/test_torch_features.py::_waves: tones plus noise), with zero
    tails past ragged lengths in both."""
    rng = np.random.RandomState(seed)
    if kind == "int16":
        x = rng.randint(-32768, 32768, size=(b, s)).astype(np.float64) / 32768.0
    else:
        t = np.arange(s) / 16000.0
        x = sum(
            0.2 * np.sin(2 * np.pi * f * t + rng.rand()) for f in (220.0, 710.0, 1900.0)
        )[None] + 0.05 * rng.randn(b, s)
    lens = np.asarray([s, s - 1234, s // 2 + 7][:b], np.int32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    return torch.from_numpy(x.astype(np.float32))


CONFIGS = {
    "flagship": dict(),
    "n_mels40": dict(n_mels=40),
    # a hop that is no multiple of 16, an odd window, no centring
    "hop100-win250": dict(win_length=250, hop_length=100, n_fft=256, center=False),
}


@pytest.mark.parametrize("kind", ["int16", "speech"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_emulation_within_the_feature_bound(kind, config):
    cfg = FeatureConfig(**CONFIGS[config])
    wave = _waves(kind)
    got = emulate(wave, cfg)
    want = log_mel_spectrogram(wave, cfg)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= TOL
    jax_cfg = JaxFeatureConfig(**CONFIGS[config])
    pallas = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wave.numpy()), jax_cfg))
    assert np.abs(got.numpy() - pallas).max() <= TOL


def test_what_bf16_pieces_and_a_missing_lo_cost():
    """Why fp16 pieces and three products: on the speech-like waves bf16
    pieces leak a tone's power into the quiet mel bands far past the bound,
    and so does fp16 without either lo piece; the kernel's choice holds it
    (8.0e-5 here, where the plain version's own f32 rounding is of that
    size)."""
    cfg = FeatureConfig()
    wave = _waves("speech")
    want = log_mel_spectrogram(wave, cfg)

    def err(**kw):
        return (emulate(wave, cfg, **kw) - want).abs().max().item()

    kept = err()
    assert kept <= TOL
    assert err(dtype=torch.bfloat16) > 10 * TOL
    assert err(pieces=("hh", "lh")) > 100 * TOL  # the basis without its lo piece
    assert err(pieces=("hh", "hl")) > 100 * TOL  # the samples without theirs


def test_silent_tiles_and_loud_waves_keep_their_scale():
    """The per-tile power of two: a wave of int16 scale (x 32768) and one of
    1e-6 give the log-mel of the unit wave shifted by 2 log of the factor,
    and a silent stretch gives log(1e-20) exactly."""
    cfg = FeatureConfig()
    wave = _waves("int16", b=2, s=16000)
    wave[1, 8000:] = 0.0
    base = emulate(wave, cfg)
    for factor in (32768.0, 1e-6):
        got = emulate(wave * factor, cfg)
        want = log_mel_spectrogram(wave * factor, cfg)
        assert (got - want).abs().max().item() <= TOL
        assert (got - base - 2 * np.log(factor)).abs()[0].max().item() <= TOL
    assert bool((base[1, 60:] == torch.log(torch.tensor(1e-20))).all())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_rows_and_basis_steps_rebuild_the_frames(config):
    """The wrapper's geometry: the rows of ``hop`` samples, reflected by
    index, hold every frame of ``frame_signal`` (frame t = rows t, t+1, ...
    cut at the window), and the basis steps rebuild the windowed DFT rows
    in that order."""
    cfg = FeatureConfig(**CONFIGS[config])
    wave = _waves("int16", b=2, s=3001)
    frames = frame_signal(wave, cfg)
    rows = fbank.sample_rows(wave, cfg)
    n_frames = frames.shape[1]
    cat = torch.cat([rows[:, c : c + n_frames] for c in range(rows.shape[1] - n_frames + 1)], -1)
    assert torch.equal(cat[..., : cfg.win_length], frames)
    steps = fbank.basis_steps(cfg)
    basis = fbank.kernel_basis(cfg)
    cos_b, sin_b = dft_basis(cfg)
    n = [c * cfg.hop_length + k0 + r for c, k0 in steps for r in range(16)]
    keep = [k0 + r < cfg.hop_length and c * cfg.hop_length + k0 + r < cfg.win_length
            for c, k0 in steps for r in range(16)]
    used = basis[np.asarray(keep)]
    assert sorted(np.asarray(n)[np.asarray(keep)].tolist()) == list(range(cfg.win_length))
    assert np.array_equal(used[:, 0 : 2 * cos_b.shape[1] : 2], cos_b)
    assert np.array_equal(used[:, 1 : 2 * cos_b.shape[1] : 2], sin_b)
    assert not basis[~np.asarray(keep)].any() and not basis[:, 2 * cos_b.shape[1] :].any()
    # 25 steps of 16 rows for the flagship's window of 400 in hops of 160
    if config == "flagship":
        assert len(steps) == 25 and fbank.smem_bytes(cfg) < fbank.SMEM_LIMIT


@pytest.mark.parametrize("n_mels", [40, 80])
def test_tap_table_is_the_filterbank(n_mels):
    cfg = FeatureConfig(n_mels=n_mels)
    fb = mel_filterbank(cfg)
    table, weights = fbank.mel_taps(cfg)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        first, w0, w1 = table[m], table[n_mels + m], table[n_mels + m + 1]
        dense[first : first + w1 - w0, m] = weights[w0:w1]
    assert np.array_equal(dense, fb)
    # each bin feeds at most two filters: about 2 n_freq taps in all
    assert weights.size <= 2 * fb.shape[0]


def test_configs_the_kernel_does_not_take_raise():
    fbank.check_config(FeatureConfig())
    with pytest.raises(ValueError, match="more than 208"):
        fbank.check_config(FeatureConfig(n_fft=512, win_length=512))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fbank.check_config(FeatureConfig(win_length=4000, hop_length=2000))
