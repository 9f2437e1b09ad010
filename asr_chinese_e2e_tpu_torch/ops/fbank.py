"""Fused log-mel fbank kernel (``csrc/fbank.cu``): the port of the TPU
kernel ``asr_chinese_e2e_tpu/ops/fbank_pallas.py::_kernel``.

``log_mel_spectrogram_kernel`` has the contract of
``log_mel_spectrogram_pallas``: (B, S) float32 in, (B, T, n_mels) float32
out. On a CPU tensor it runs the plain version
(``data/features.py::log_mel_spectrogram``); on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from ..data.features import (
    FeatureConfig,
    fbank_bases,
    log_mel_spectrogram,
    reflect_pad,
)
from ._build import check, load_library


def log_mel_spectrogram_kernel(wave: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """(B, S) float32 -> (B, T, n_mels) float32 log-mel."""
    if wave.device.type == "cpu":
        return log_mel_spectrogram(wave, cfg)
    if wave.device.type != "cuda":
        raise ValueError(f"fbank kernel: unsupported device {wave.device}")
    if wave.dtype != torch.float32 or wave.dim() != 2:
        raise ValueError(
            f"fbank kernel: want (B, S) float32, got {tuple(wave.shape)} {wave.dtype}"
        )
    # centring is done here, as the JAX wrapper does before its pallas_call
    wave = reflect_pad(wave, cfg).contiguous()
    bsz, s = wave.shape
    n_frames = (s - cfg.win_length) // cfg.hop_length + 1
    if n_frames < 1:
        raise ValueError(f"fbank kernel: {s} samples is shorter than one frame")
    cos_b, sin_b, fb = fbank_bases(cfg, wave.device)
    n_freq, n_mels = fb.shape
    out = torch.empty((bsz, n_frames, n_mels), dtype=torch.float32, device=wave.device)
    lib = load_library()
    with torch.cuda.device(wave.device):
        err = lib.asr_fbank(
            wave.data_ptr(), bsz, s, n_frames,
            cos_b.data_ptr(), sin_b.data_ptr(), fb.data_ptr(), out.data_ptr(),
            cfg.win_length, cfg.hop_length, n_freq, n_mels,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_fbank")
    log_mel_spectrogram_kernel.launches += 1
    return out


# kernel launches so far (the CPU path does not count)
log_mel_spectrogram_kernel.launches = 0
