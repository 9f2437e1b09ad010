"""Plain features: int16 waves -> log-mel (HTK triangles over a periodic-Hann
power spectrum, centred frames with reflect padding) -> per-utterance CMVN
over the valid frames (sample std) -> optional SpecAugment -> low frame rate
stacking (m frames every n, the tail repeating the last valid frame).

SpecAugment draws its masks from a CPU generator in the order the
configuration's recipe fixes: per mask a width cap U[0, P), a start U[0,
dim - cap) and a width U[0, cap), each a float64 uniform scaled and floored,
the frequency masks first, filled with the utterance's mean."""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_EPS = 1e-20


def mel_filters(feat: dict) -> torch.Tensor:
    """(n_freqs, n_mels) HTK-scale triangles, float64 -> float32."""
    sr, n_fft, n_mels = feat["sample_rate"], feat["n_fft"], feat["n_mels"]
    f_max = feat.get("f_max") or sr / 2.0
    n_freqs = n_fft // 2 + 1

    def mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    pts = np.linspace(mel(feat["f_min"]), mel(f_max), n_mels + 2)
    hz = 700.0 * (10.0 ** (pts / 2595.0) - 1.0)
    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    out = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        out[:, m] = np.maximum(0.0, np.minimum(rise, fall))
    return torch.from_numpy(out.astype(np.float32))


def num_frames(n_samples, feat: dict):
    return n_samples // feat["hop_length"] + 1


def log_mel(wave: torch.Tensor, feat: dict) -> torch.Tensor:
    """(B, S) float32 -> (B, T, n_mels)."""
    n_fft, win, hop = feat["n_fft"], feat["win_length"], feat["hop_length"]
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=wave.device)
    spec = torch.stft(wave, n_fft, hop_length=hop, win_length=win, window=window,
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.real.square() + spec.imag.square()  # (B, F, T)
    mel = mel_filters(feat).to(wave.device)
    return torch.log(torch.einsum("bft,fm->btm", power, mel) + LOG_EPS)


def _valid(t: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]).float()


def cmvn(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    mask = _valid(x.shape[1], lengths)[..., None]
    n = lengths.float()[:, None, None] * x.shape[2]
    mean = (x * mask).sum(dim=(1, 2), keepdim=True) / n
    var = ((x - mean).square() * mask).sum(dim=(1, 2), keepdim=True) / (n - 1.0)
    return (x - mean) / var.sqrt() * mask


def _draw(gen: torch.Generator, hi: torch.Tensor) -> torch.Tensor:
    u = torch.rand(hi.shape, generator=gen, dtype=torch.float64)
    return torch.minimum((u * hi).floor().long(), hi - 1)


def _mask(gen, b: int, dim: int, param: int, lengths=None) -> torch.Tensor:
    cap = _draw(gen, torch.full((b,), param, dtype=torch.int64))
    top = lengths.cpu().long() if lengths is not None else torch.full((b,), dim)
    start = _draw(gen, (top - cap).clamp(min=1))
    width = torch.where(cap == 0, torch.zeros_like(cap), _draw(gen, cap.clamp(min=1)))
    pos = torch.arange(dim)[None, :]
    return (pos >= start[:, None]) & (pos < (start + width)[:, None])


def spec_augment(x, lengths, feat: dict, gen: torch.Generator):
    if feat.get("num_time_warps", 0):
        raise ValueError("the reference has no time warp")
    b, t, d = x.shape
    freq = [_mask(gen, b, d, feat["freq_mask_param"]) for _ in range(feat["num_freq_masks"])]
    time = [_mask(gen, b, t, feat["time_mask_param"], lengths)
            for _ in range(feat["num_time_masks"])]
    valid = _valid(t, lengths)[..., None]
    fill = (x * valid).sum(dim=(1, 2)) / (lengths.float() * d).clamp(min=1.0)
    fill = fill[:, None, None]
    for m in freq:
        x = torch.where(m.to(x.device)[:, None, :], fill, x)
    for m in time:
        x = torch.where(m.to(x.device)[:, :, None], fill, x)
    return x * valid


def lfr(x: torch.Tensor, lengths: torch.Tensor, feat: dict):
    b, t, d = x.shape
    m, n = feat["lfr_m"], feat["lfr_n"]
    t_out = math.ceil(t / n)
    dev = x.device
    idx = torch.arange(t_out, device=dev)[:, None] * n + torch.arange(m, device=dev)[None, :]
    idx = torch.minimum(idx[None], (lengths - 1)[:, None, None]).reshape(b, t_out * m)
    out = torch.gather(x, 1, idx[..., None].expand(b, t_out * m, d)).reshape(b, t_out, m * d)
    out_len = (lengths + n - 1) // n
    return out * _valid(t_out, out_len)[..., None], out_len


def features(wave_i16: torch.Tensor, wave_lengths: torch.Tensor, feat: dict,
             augment_gen: torch.Generator | None = None):
    """(B, S) int16 waves padded with zeros, sample lengths -> (B, T', m
    n_mels) features and their frame lengths."""
    wave = wave_i16.float() / 32768.0
    x = log_mel(wave, feat)
    lengths = num_frames(wave_lengths.long(), feat)
    x = cmvn(x, lengths)
    if augment_gen is not None:
        x = spec_augment(x, lengths, feat, augment_gen)
    return lfr(x, lengths, feat)
