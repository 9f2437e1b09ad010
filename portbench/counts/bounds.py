"""The least time the card could take for a kernel's call: the larger of its
bytes (inputs read once, outputs written once) over the memory rate and its
operations over the peak of their type. Copies of ``chip_smoke.py``'s
``bound``, ``attention_fwd_bound``, ``attention_bwd_bound``,
``ctc_alpha_bound``, ``ctc_beta_bound``, ``fbank_bound`` and
``ctc_prefix_beam_bound`` (``portbench/tests`` holds them equal); each
returns ``bound_ms``, ``bound_by``, ``bytes`` and ``flops``."""

from __future__ import annotations

import numpy as np

from .peaks import H100_SXM_BF16_PEAK, H100_SXM_BYTES_PER_S, H100_SXM_F32_PEAK


def bound(n_bytes: float, flops: float, peak: float) -> dict:
    by_bytes = n_bytes / H100_SXM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bytes": n_bytes, "flops": flops,
    }


def _attention_bound(q_side, k_side, n_products, b, h, tq, tk, d, itemsize, pairs):
    pairs = b * h * tq * tk if pairs is None else pairs
    peak = H100_SXM_BF16_PEAK if itemsize == 2 else H100_SXM_F32_PEAK
    n_bytes = itemsize * b * h * d * (q_side * tq + k_side * tk)
    return bound(n_bytes, n_products * 2.0 * pairs * d, peak)


def attention_fwd_bound(b, h, tq, tk, d, itemsize=2, pairs=None) -> dict:
    """K1: q, k, v read and the output written; Q K^T and W V."""
    return _attention_bound(2, 2, 2, b, h, tq, tk, d, itemsize, pairs)


def attention_bwd_bound(b, h, tq, tk, d, itemsize=2, pairs=None) -> dict:
    """K2: q, k, v, o, dO read and dq, dk, dv written; five products."""
    return _attention_bound(4, 4, 5, b, h, tq, tk, d, itemsize, pairs)


def ctc_alpha_bound(b, t, c, s, itemsize=2) -> dict:
    """K3: the logits read; the (B, T, S) alpha table, the log-sum-exp and
    the loss written."""
    n_bytes = itemsize * b * t * c + 4.0 * (b * t * s + b * t + b)
    return bound(n_bytes, 4.0 * b * t * c + 8.0 * b * t * s, H100_SXM_F32_PEAK)


def ctc_beta_bound(b, t, c, s, itemsize=2) -> dict:
    """K4: the logits, alpha, log-sum-exp and loss read; the gradient
    written in the logits' type."""
    n_bytes = 2.0 * itemsize * b * t * c + 4.0 * (b * t * s + b * t + 2 * b)
    return bound(n_bytes, 4.0 * b * t * c + 12.0 * b * t * s, H100_SXM_F32_PEAK)


def mel_filterbank(sample_rate=16000, n_fft=400, n_mels=80, f_min=40.0, f_max=None) -> np.ndarray:
    """(n_freqs, n_mels) HTK triangles (for the count of non-zero taps)."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    to_mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)
    mel_pts = np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (mel_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def fbank_bound(b, n_samples, sample_rate=16000, n_fft=400, win_length=400,
                hop_length=160, n_mels=80, f_min=40.0) -> dict:
    """K5: the waveform read, the log-mel written, f32; the window, a real
    FFT (2.5 n log2 n), the power, the non-zero mel taps and the log."""
    frames = b * (n_samples // hop_length + 1)
    n_bins = n_fft // 2 + 1
    taps = int(np.count_nonzero(mel_filterbank(sample_rate, n_fft, n_mels, f_min)))
    per_frame = win_length + 2.5 * n_fft * np.log2(n_fft) + 3.0 * n_bins + 2.0 * taps + n_mels
    return bound(4.0 * (b * n_samples + frames * n_mels), float(frames * per_frame),
                 H100_SXM_F32_PEAK)


def ctc_prefix_beam_bound(lens, t, c, k, p, l) -> dict:
    """K9 over utterances of ``lens`` frames (of T = ``t``)."""
    b = len(lens)
    frames = float(sum(min(int(n), t) for n in lens))
    n_bytes = 4.0 * frames * c + 8.0 * b + 8.0 * b * k * l + 12.0 * b * k
    flops = frames * (c + k * k * l + 10 * k * (p + 1))
    return bound(n_bytes, flops, H100_SXM_F32_PEAK)
