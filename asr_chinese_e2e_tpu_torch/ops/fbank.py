"""Fused log-mel fbank kernel (``csrc/fbank.cu``): the port of the TPU
kernel ``asr_chinese_e2e_tpu/ops/fbank_pallas.py::_kernel``.

``log_mel_spectrogram_kernel`` has the contract of
``log_mel_spectrogram_pallas``: (B, S) float32 in, (B, T, n_mels) float32
out. On a CPU tensor it runs the plain version
(``data/features.py::log_mel_spectrogram``); on a CUDA tensor it launches
the kernel or raises.

The kernel computes re|im of 64 frames as sum_c A_c W_c over the rows of
``hop`` samples (``sample_rows``), on the tensor cores with fp16 hi + lo
pieces of both operands (three products), against the interleaved
cos|sin basis of ``kernel_basis`` split in 16-row steps (``basis_steps``),
then the mel filters by their non-zero taps (``mel_taps``). The tables
here are what the kernel reads; ``tests/test_torch_fbank_mma.py`` rehearses
its arithmetic on them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..data.features import (
    FeatureConfig,
    dft_basis,
    log_mel_spectrogram,
    mel_filterbank,
)
from ._build import check, load_library

# the kernel's compile-time shape (csrc/fbank.cu)
FRAMES = 64  # frames per block
COLS = 416  # interleaved cos|sin columns of the basis: n_freq <= 208
STAGES, LDB, WARPS = 4, COLS + 8, 8
SMEM_LIMIT = 227 * 1024


def _reflect_pad(cfg: FeatureConfig) -> int:
    return cfg.n_fft // 2 if cfg.center else 0


def basis_steps(cfg: FeatureConfig) -> list[tuple[int, int]]:
    """The kernel's 16-row basis steps in order, as (row offset c, first
    column k0 of a sample row): a frame is the rows t, ..., t + C - 1 of
    ``hop`` samples, row c up to win - c hop."""
    hop, win = cfg.hop_length, cfg.win_length
    steps = []
    for c in range(-(-win // hop)):
        width = min(hop, win - c * hop)
        steps += [(c, k0) for k0 in range(0, width, 16)]
    return steps


def kernel_basis(cfg: FeatureConfig) -> np.ndarray:
    """(steps x 16, COLS) f32: step (c, k0)'s row r holds window row c hop
    + k0 + r of the windowed DFT with cos and sin interleaved (column 2f =
    cos f, 2f + 1 = sin f); rows past ``hop`` or the window and columns
    past 2 n_freq are zero."""
    cos_b, sin_b = dft_basis(cfg)
    n_freq = cos_b.shape[1]
    steps = basis_steps(cfg)
    out = np.zeros((16 * len(steps), COLS), np.float32)
    for s, (c, k0) in enumerate(steps):
        for r in range(16):
            col, n = k0 + r, c * cfg.hop_length + k0 + r
            if col < cfg.hop_length and n < cfg.win_length:
                out[16 * s + r, 0 : 2 * n_freq : 2] = cos_b[n]
                out[16 * s + r, 1 : 2 * n_freq : 2] = sin_b[n]
    return out


def mel_taps(cfg: FeatureConfig) -> tuple[np.ndarray, np.ndarray]:
    """The triangular filters by their non-zero taps: (int32 table of 2
    n_mels + 1: each filter's first bin, then the offsets of its weights,
    the last one the count of all; f32 weights). A filter's taps are
    contiguous bins."""
    fb = mel_filterbank(cfg)
    firsts, offsets, weights = [], [0], []
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        first = int(nz[0]) if nz.size else 0
        count = int(nz[-1]) + 1 - first if nz.size else 0
        firsts.append(first)
        weights.append(fb[first : first + count, m])
        offsets.append(offsets[-1] + count)
    table = np.asarray(firsts + offsets, np.int32)
    return table, np.concatenate(weights).astype(np.float32)


def split_fp16(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) fp16 pieces of an f32 tensor: hi = fp16(x), lo = fp16(x -
    hi)."""
    hi = x.to(torch.float16)
    return hi, (x - hi.float()).to(torch.float16)


@functools.lru_cache(maxsize=16)
def smem_bytes(cfg: FeatureConfig) -> int:
    """Dynamic shared memory of one block, as ``asr_fbank`` reckons it: the
    fp16 pieces of the sample rows, the basis stages, the f32 sample rows
    as copied, the tap table."""
    c = -(-cfg.win_length // cfg.hop_length)
    w = 16 * -(-cfg.hop_length // 16)
    taps, weights = mel_taps(cfg)
    x_bytes = 2 * 2 * (FRAMES + c - 1) * (w + 8)
    stage_bytes = 2 * STAGES * 2 * 16 * LDB
    raw_bytes = 4 * (FRAMES + c - 1) * cfg.hop_length
    return x_bytes + stage_bytes + raw_bytes + 4 * taps.size + 4 * (weights.size + WARPS)


@functools.lru_cache(maxsize=16)
def check_config(cfg: FeatureConfig) -> None:
    """Raise ValueError for a configuration the kernel does not take (a
    configuration that passes is remembered: the call's host work)."""
    n_freq = cfg.n_fft // 2 + 1
    if 2 * n_freq > COLS:
        raise ValueError(
            f"fbank kernel: n_fft {cfg.n_fft} gives {n_freq} bins, more than {COLS // 2}")
    power_bytes = 4 * FRAMES * (8 * -(-n_freq // 8) + 4)
    if power_bytes > 2 * STAGES * 2 * 16 * LDB or smem_bytes(cfg) > SMEM_LIMIT:
        raise ValueError(
            f"fbank kernel: win {cfg.win_length} hop {cfg.hop_length} n_mels {cfg.n_mels} "
            f"needs {smem_bytes(cfg)} bytes of shared memory, more than {SMEM_LIMIT}")


@functools.lru_cache(maxsize=16)
def kernel_tables(cfg: FeatureConfig, device: torch.device):
    """(basis (2, steps x 16, COLS) fp16 hi and lo, tap table int32, tap
    weights f32) on ``device``, built once per (config, device)."""
    hi, lo = split_fp16(torch.from_numpy(kernel_basis(cfg)))
    table, weights = mel_taps(cfg)
    return (
        torch.stack([hi, lo]).to(device),
        torch.from_numpy(table).to(device),
        torch.from_numpy(weights).to(device),
    )


def sample_rows(wave: torch.Tensor, cfg: FeatureConfig, n_rows: int | None = None):
    """(B, S) -> (B, n_rows, hop): the reflect-padded wave as rows of
    ``hop`` samples, zero past its end, as the kernel's loader stages them
    (it reflects the index: the wrapper makes no padded copy). By default
    the T + C - 1 rows the frames cover."""
    bsz, s = wave.shape
    pad, hop = _reflect_pad(cfg), cfg.hop_length
    if n_rows is None:
        n_frames = (s + 2 * pad - cfg.win_length) // hop + 1
        n_rows = n_frames + -(-cfg.win_length // hop) - 1
    p = torch.arange(n_rows * hop, device=wave.device)
    i = (p - pad).abs()
    i = torch.where(i >= s, 2 * (s - 1) - i, i)
    x = wave[:, i.clamp(0, s - 1)] * (p < s + 2 * pad)
    return x.reshape(bsz, n_rows, hop)


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
    check_config(cfg)
    wave = wave.contiguous()
    bsz, s = wave.shape
    pad = _reflect_pad(cfg)
    if pad >= s:  # as torch's reflect padding
        raise ValueError(f"fbank kernel: {s} samples is too short to reflect {pad}")
    n_frames = (s + 2 * pad - cfg.win_length) // cfg.hop_length + 1
    if n_frames < 1:
        raise ValueError(f"fbank kernel: {s} samples is shorter than one frame")
    basis, taps, weights = kernel_tables(cfg, wave.device)
    out = torch.empty((bsz, n_frames, cfg.n_mels), dtype=torch.float32, device=wave.device)
    lib = load_library()
    with torch.cuda.device(wave.device):
        err = lib.asr_fbank(
            wave.data_ptr(), bsz, s, n_frames, pad, basis.data_ptr(), basis.shape[1] // 16,
            taps.data_ptr(), weights.data_ptr(), weights.numel(), out.data_ptr(),
            cfg.win_length, cfg.hop_length, cfg.n_fft // 2 + 1, cfg.n_mels,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_fbank")
    log_mel_spectrogram_kernel.launches += 1
    return out


# kernel launches so far (the CPU path does not count)
log_mel_spectrogram_kernel.launches = 0
