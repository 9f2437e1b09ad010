"""Length/causal mask builders: additive biases, 0 = attend and NEG_INF =
blocked (``asr_chinese_e2e_tpu/ops/masks.py:16-47``)."""

from __future__ import annotations

import torch

NEG_INF = -1e9  # finite, to avoid NaN from (-inf) - (-inf) in softmax shifts


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, T) bool, True = valid position."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def padding_bias(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) -> (B, 1, 1, T) float32 bias blocking padded KEY positions."""
    valid = length_mask(lengths, max_len)
    zero = torch.zeros((), dtype=torch.float32, device=lengths.device)
    return torch.where(valid, zero, NEG_INF)[:, None, None, :]


def causal_bias(max_len: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) float32 bias blocking future positions."""
    row = torch.arange(max_len, device=device)[:, None]
    col = torch.arange(max_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(col <= row, zero, NEG_INF)[None, None]


def causal_padding_bias(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Combined causal + key-padding bias for decoder self-attention."""
    return causal_bias(max_len, lengths.device) + padding_bias(lengths, max_len)


def banded_bias(max_len: int, band: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) bias allowing only |i - j| <= band."""
    row = torch.arange(max_len, device=device)[:, None]
    col = torch.arange(max_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where((col - row).abs() <= band, zero, NEG_INF)[None, None]


def causal_banded_bias(max_len: int, band: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) bias allowing only i - band <= j <= i."""
    row = torch.arange(max_len, device=device)[:, None]
    col = torch.arange(max_len, device=device)[None, :]
    keep = (col <= row) & (row - col <= band)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(keep, zero, NEG_INF)[None, None]
