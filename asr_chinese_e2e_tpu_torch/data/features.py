"""Batched feature pipeline in torch: log-mel fbank -> [MFCC] -> [delta] ->
CMVN -> [SpecAugment] -> LFR frame stacking.

Counterpart of ``asr_chinese_e2e_tpu/data/features.py``. The STFT is the
same pair of windowed-DFT matmuls (periodic Hann, power 2), the mel bank
the same HTK triangles, CMVN the same masked per-utterance statistics
(ddof=1), SpecAugment the same time warp (``data/timewarp.py``) and
two-stage mask draw filled with the utterance mean, and LFR the same
clipped gather. The warps and masks are drawn from an explicit
``torch.Generator`` (jax.random's bits cannot be reproduced).

Shapes are static per bucket; variable length rides in ``lengths``
tensors, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .timewarp import time_warp

LOG_EPS = 1e-20  # processor.py:38


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Field-for-field copy of the JAX package's ``FeatureConfig`` (one
    ``config.json`` configures both)."""

    sample_rate: int = 16000
    n_mels: int = 80
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 40.0
    f_max: float | None = None  # None -> sample_rate / 2
    n_fft: int = 400
    center: bool = True
    lfr_m: int = 4
    lfr_n: int = 3
    freq_mask_param: int = 30
    time_mask_param: int = 40
    num_freq_masks: int = 1
    num_time_masks: int = 1
    num_time_warps: int = 0
    time_warp_param: int = 5
    cmvn_mode: str = "global"  # "global" | "per_dim" | "fixed"
    cmvn_mean: float = 0.0
    cmvn_std: float = 1.0
    use_delta: bool = False
    use_delta_delta: bool = False
    feature_type: str = "fbank"  # "fbank" | "mfcc"
    n_mfcc: int = 40
    fbank_impl: str = "xla"  # "xla" (plain torch) | "pallas" (ops/fbank kernel)

    @property
    def base_dim(self) -> int:
        """Per-frame dim before delta stacking and LFR."""
        return self.n_mfcc if self.feature_type == "mfcc" else self.n_mels

    @property
    def feature_dim(self) -> int:
        mult = 1 + int(self.use_delta) + int(self.use_delta_delta)
        return self.base_dim * mult * self.lfr_m

    def num_frames(self, num_samples):
        """STFT frame count for a waveform of ``num_samples`` samples."""
        if self.center:
            return num_samples // self.hop_length + 1
        return (num_samples - self.win_length) // self.hop_length + 1

    def num_lfr_frames(self, num_frames):
        """ceil(T / n) (``processor.py:90``)."""
        return -(-num_frames // self.lfr_n)


# ---------------------------------------------------------------------------
# numpy bases (shared text with the JAX package)
# ---------------------------------------------------------------------------


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(cfg: FeatureConfig) -> np.ndarray:
    """(n_freqs, n_mels) triangular mel filterbank, HTK scale."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    n_freqs = cfg.n_fft // 2 + 1
    all_freqs = np.linspace(0, cfg.sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(cfg.f_min), hz_to_mel(f_max), cfg.n_mels + 2)
    f_pts = mel_to_hz(mel_pts)  # (n_mels + 2,)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) orthonormal DCT-II basis (scipy ``norm='ortho'``)."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    basis = np.cos(np.pi * (n + 0.5) * k / n_in)
    scale = np.full((1, n_out), np.sqrt(2.0 / n_in))
    scale[0, 0] = np.sqrt(1.0 / n_in)
    return (basis * scale).astype(np.float32)


def dft_basis(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT bases: (win, n_freqs) cos and -sin matrices."""
    n_freqs = cfg.n_fft // 2 + 1
    window = np.hanning(cfg.win_length + 1)[:-1]  # periodic hann (torch default)
    k = np.arange(n_freqs)[None, :]
    t = np.arange(cfg.win_length)[:, None]
    ang = 2.0 * np.pi * t * k / cfg.n_fft
    cos_b = (window[:, None] * np.cos(ang)).astype(np.float32)
    sin_b = (-window[:, None] * np.sin(ang)).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=16)
def fbank_bases(cfg: FeatureConfig, device: torch.device):
    """(cos (win, F), sin (win, F), mel (F, n_mels)) float32 on ``device``,
    built once per (config, device)."""
    cos_b, sin_b = dft_basis(cfg)
    return tuple(
        torch.from_numpy(a).to(device)
        for a in (cos_b, sin_b, mel_filterbank(cfg))
    )


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------


def reflect_pad(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """torch.stft-style centring: reflect-pad n_fft // 2 each side."""
    if not cfg.center:
        return wave
    pad = cfg.n_fft // 2
    return F.pad(wave[:, None, :], (pad, pad), mode="reflect")[:, 0]


def frame_signal(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) -> (B, T, win) overlapping frames (reflect-padded when
    ``center``)."""
    return reflect_pad(wave, cfg).unfold(1, cfg.win_length, cfg.hop_length)


def logmel_from_frames(frames: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, T, win) framed audio -> (B, T, n_mels) log-mel."""
    cos_b, sin_b, fb = fbank_bases(cfg, frames.device)
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im  # (B, T, n_freqs)
    return torch.log(power @ fb + LOG_EPS)


def log_mel_spectrogram(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) float32 -> (B, T, n_mels) log-mel: the plain version of the
    fbank kernel (``ops/fbank.py``)."""
    return logmel_from_frames(frame_signal(wave, cfg), cfg)


def _frame_mask(feats: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) float mask of valid frames."""
    t = feats.shape[1]
    valid = torch.arange(t, device=feats.device)[None, :] < lengths[:, None]
    return valid.to(feats.dtype)[..., None]


def cmvn(feats: torch.Tensor, feat_lengths: torch.Tensor, eps: float = 0.0):
    """Per-utterance global CMVN over valid frames, sample std (ddof=1)."""
    mask = _frame_mask(feats, feat_lengths)
    n = feat_lengths.to(feats.dtype)[:, None, None] * feats.shape[2]
    mean = (feats * mask).sum(dim=(1, 2), keepdim=True) / n
    var = ((feats - mean).square() * mask).sum(dim=(1, 2), keepdim=True) / (
        n - 1.0
    )
    return (feats - mean) / (var.sqrt() + eps) * mask


def cmvn_per_dim(
    feats: torch.Tensor, feat_lengths: torch.Tensor, eps: float = 1e-16
):
    """Per-dim CMVN over time (population std), masked to valid frames."""
    mask = _frame_mask(feats, feat_lengths)
    n = feat_lengths.to(feats.dtype).clamp(min=1.0)[:, None, None]
    mean = (feats * mask).sum(dim=1, keepdim=True) / n
    var = ((feats - mean).square() * mask).sum(dim=1, keepdim=True) / n
    return (feats - mean) / (var.sqrt() + eps) * mask


def delta_features(feats: torch.Tensor, order_n: int = 2) -> torch.Tensor:
    """HTK-style delta, edge-replicated:
    d_t = sum_n n * (x[t+n] - x[t-n]) / (2 * sum n^2)."""
    denom = 2.0 * sum(n * n for n in range(1, order_n + 1))
    t = feats.shape[1]
    idx = torch.arange(t, device=feats.device)
    out = torch.zeros_like(feats)
    for n in range(1, order_n + 1):
        fwd = feats[:, (idx + n).clamp(max=t - 1)]
        bwd = feats[:, (idx - n).clamp(min=0)]
        out = out + n * (fwd - bwd)
    return out / denom


def lfr_stack(feats: torch.Tensor, feat_lengths: torch.Tensor, cfg: FeatureConfig):
    """Stack m frames every n, the tail padded with the last valid frame
    (clipped gather). (B, T, D) -> (B, ceil(T/n), m*D), lengths ceil(len/n)."""
    b, t, d = feats.shape
    m, n = cfg.lfr_m, cfg.lfr_n
    t_lfr = -(-t // n)
    dev = feats.device
    idx = torch.arange(t_lfr, device=dev)[:, None] * n + torch.arange(m, device=dev)
    idx = torch.minimum(idx[None], (feat_lengths - 1)[:, None, None])  # (B, T_lfr, m)
    stacked = feats[torch.arange(b, device=dev)[:, None, None], idx]
    stacked = stacked.reshape(b, t_lfr, m * d)
    out_lengths = -(-feat_lengths // n)
    valid = torch.arange(t_lfr, device=dev)[None, :] < out_lengths[:, None]
    return stacked * valid.to(feats.dtype)[..., None], out_lengths


def _uniform_int(generator: torch.Generator, hi: torch.Tensor) -> torch.Tensor:
    """One draw per row, uniform on [0, hi) (hi >= 1, int64)."""
    u = torch.rand(hi.shape, generator=generator, dtype=torch.float64)
    return torch.minimum((u * hi).floor().long(), hi - 1)


def _spec_mask(generator, b: int, dim: int, param: int, lengths=None):
    """One batch of SpecAugment masks by the reference's two-stage draw:
    width_cap ~ U[0, P), start ~ U[0, dim - width_cap) (dim bounded by
    ``lengths`` when given), width ~ U[0, width_cap). (B, dim) bool, on
    the CPU."""
    cap = _uniform_int(generator, torch.full((b,), param, dtype=torch.int64))
    max_dim = lengths.cpu().long() if lengths is not None else torch.full((b,), dim)
    start = _uniform_int(generator, (max_dim - cap).clamp(min=1))
    width = _uniform_int(generator, cap.clamp(min=1))
    width = torch.where(cap == 0, torch.zeros_like(width), width)
    pos = torch.arange(dim)[None, :]
    return (pos >= start[:, None]) & (pos < (start + width)[:, None])


def apply_spec_masks(feats, feat_lengths, freq_masks, time_masks):
    """Fill each (B, D) freq mask and (B, T) time mask with the utterance's
    mean over valid frames; zero past the length."""
    b, t, d = feats.shape
    valid = _frame_mask(feats, feat_lengths)
    n_valid = (feat_lengths.to(feats.dtype) * d).clamp(min=1.0)
    fill = (feats * valid).sum(dim=(1, 2)) / n_valid
    fill = fill[:, None, None].to(feats.dtype)
    masked = feats
    for fm in freq_masks:
        masked = torch.where(fm.to(feats.device)[:, None, :], fill, masked)
    for tm in time_masks:
        masked = torch.where(tm.to(feats.device)[:, :, None], fill, masked)
    return masked * valid


def spec_augment(feats, feat_lengths, cfg: FeatureConfig, generator: torch.Generator):
    """SpecAugment (``augments.py:4-42``): first ``num_time_warps`` time
    warps of at most ``time_warp_param`` frames (``data/timewarp.py``), then
    ``num_freq_masks`` masks of width < ``freq_mask_param`` and
    ``num_time_masks`` masks of width < ``time_mask_param`` inside each
    utterance's length, independent per utterance, all drawn from
    ``generator`` (a CPU generator)."""
    for _ in range(cfg.num_time_warps):
        feats = time_warp(feats, feat_lengths, generator, cfg.time_warp_param)
    b, t, d = feats.shape
    freq = [_spec_mask(generator, b, d, cfg.freq_mask_param)
            for _ in range(cfg.num_freq_masks)]
    time = [_spec_mask(generator, b, t, cfg.time_mask_param, feat_lengths)
            for _ in range(cfg.num_time_masks)]
    return apply_spec_masks(feats, feat_lengths, freq, time)


def parse_batch(
    wave: torch.Tensor,
    wave_lengths: torch.Tensor,
    cfg: FeatureConfig,
    augment: bool = False,
    generator: torch.Generator | None = None,
):
    """(B, S) waveforms + sample lengths -> (B, T_lfr, feature_dim) features
    + frame lengths. int16 input is scaled by 1/32768 first (the wire
    format); ``cfg.fbank_impl == "pallas"`` selects the fbank kernel.
    ``augment`` applies SpecAugment after CMVN, with masks drawn from
    ``generator``."""
    if augment and generator is None:
        raise ValueError("augment=True requires a generator")
    if not torch.is_floating_point(wave):
        wave = wave.to(torch.float32) * (1.0 / 32768.0)
    if cfg.fbank_impl == "pallas":
        from ..ops.fbank import log_mel_spectrogram_kernel

        feats = log_mel_spectrogram_kernel(wave, cfg)
    elif cfg.fbank_impl == "xla":
        feats = log_mel_spectrogram(wave, cfg)
    else:
        raise ValueError(f"unknown fbank_impl {cfg.fbank_impl!r}")
    feat_lengths = cfg.num_frames(wave_lengths.to(torch.int64))
    if cfg.feature_type == "mfcc":
        feats = feats @ torch.from_numpy(dct_matrix(cfg.n_mels, cfg.n_mfcc)).to(
            feats.device
        )
    if cfg.use_delta or cfg.use_delta_delta:
        parts = [feats]
        d1 = delta_features(feats)
        if cfg.use_delta:
            parts.append(d1)
        if cfg.use_delta_delta:
            parts.append(delta_features(d1))
        feats = torch.cat(parts, dim=-1)
    if cfg.cmvn_mode == "per_dim":
        feats = cmvn_per_dim(feats, feat_lengths)
    elif cfg.cmvn_mode == "fixed":
        mask = _frame_mask(feats, feat_lengths)
        feats = ((feats - cfg.cmvn_mean) / cfg.cmvn_std) * mask
    else:
        feats = cmvn(feats, feat_lengths)
    if augment:
        feats = spec_augment(feats, feat_lengths, cfg, generator)
    return lfr_stack(feats, feat_lengths, cfg)
