"""The rel-pos conformer's frozen yardstick (``espnet-conformer``): the
matmul FLOPs of a train step (elementwise work left out, fwd + bwd = 3x
fwd, as ``flops.analytic_train_flops`` counts the transformer's) and the
least time of the rel-pos attention kernels K11 and K12, by the H100's
peaks (``peaks.py``) and ``bounds.bound``."""

from __future__ import annotations

from .bounds import bound
from .flops import fbank_flops, num_frames
from .peaks import H100_SXM_BF16_PEAK


def frontend_rows(n: int) -> int:
    """Rows of ``n`` left after the two valid 3x3 stride-2 convolutions."""
    return ((n - 1) // 2 - 1) // 2


def encoder_frames(feat: dict, n_samples: int) -> int:
    """T' of an utterance padded to ``n_samples`` (LFR 1/1, then the
    subsampler)."""
    return frontend_rows(num_frames(feat, n_samples))


def analytic_train_flops(cfg: dict, feat: dict, vocab_size: int, batch: int,
                         n_samples: int, label_len: int) -> float:
    """Matmul FLOPs of one train step of ``batch`` utterances padded to
    ``n_samples`` with ``label_len`` labels: per utterance the fbank, the
    two convolutions and the projection of the frontend, per block two
    FFNs, the four attention projections, (q + u) K^T, (q + v) P^T over
    the 2T - 1 relative rows, W V, the conv module's two pointwise and its
    depthwise products; the CTC head; the decoder as
    ``flops.analytic_train_flops`` counts it; and per batch each block's
    projection of the relative table (shared by the utterances)."""
    t_frames = num_frames(feat, n_samples)
    d, ff, c, k = cfg["d_model"], cfg["d_ff"], cfg["frontend_channels"], cfg["conv_kernel_size"]
    le, ld, v = cfg["num_encoder_layers"], cfg["num_decoder_layers"], vocab_size
    n_mels = feat["n_mels"]
    t1, f1 = (t_frames - 1) // 2, (n_mels - 1) // 2
    t, f2 = frontend_rows(t_frames), frontend_rows(n_mels)
    l = label_len + 1
    fwd = fbank_flops(feat, t_frames)
    fwd += t1 * f1 * c * 9 * 2 + t * f2 * c * 9 * c * 2 + t * f2 * c * d * 2
    block = (2 * 2 * t * d * ff * 2 + 4 * t * d * d * 2 + t * (2 * t - 1) * d * 2
             + 2 * t * t * d * 2 + t * d * 2 * d * 2 + t * d * d * 2 + t * d * k * 2)
    fwd += le * block + t * d * v * 2
    fwd += ld * (4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2
                 + 2 * t * d * d * 2 + 2 * l * t * d * 2 + 2 * l * d * ff * 2)
    fwd += l * d * v * 2
    per_batch = le * (2 * t - 1) * d * d * 2
    return 3.0 * (fwd * batch + per_batch)


def relpos_fwd_bound(b, h, t, d) -> dict:
    """K11 (bf16): q, k, v read and the output written, the T positional
    terms a row reads of pos; Q K^T and W V."""
    n_bytes = 2.0 * (4 * b * h * t * d + b * h * t * t)
    return bound(n_bytes, 2 * 2.0 * b * h * t * t * d, H100_SXM_BF16_PEAK)


def relpos_bwd_bound(b, h, t, d) -> dict:
    """K12 (bf16): q, k, v, o, dO and the positional terms read, dq, dk,
    dv and their gradients written; five products."""
    n_bytes = 2.0 * (8 * b * h * t * d + 2 * b * h * t * t)
    return bound(n_bytes, 5 * 2.0 * b * h * t * t * d, H100_SXM_BF16_PEAK)
