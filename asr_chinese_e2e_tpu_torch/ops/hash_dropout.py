"""Hash dropout in one pass (``csrc/hash_dropout.cu``, K10): ``x`` times
the hash keep mask of ``models/layers.py::hash_keep_mask``, forward and
backward, without the mask.

K10 replaces no TPU kernel: the JAX package's
``ConfigurableDropout(impl="hash")`` is elementwise integer code that XLA
fuses into the multiply, while the same code as PyTorch tensor operations
is a chain of about 35 launches a mask through full-size int64
temporaries. The kernel takes the seed, the offset, the keep threshold and
the kept value as arguments, so a call copies nothing to the card.

``hash_dropout`` is differentiable in ``x``: its backward is the same
dropout of the gradient (the mask's product rule), and it saves no tensor.
On CPU tensors it runs the plain version ``hash_dropout_reference``; on
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import functools
import math

import torch

from ._build import check, load_library
from .fused_attention import _M32, _keep_threshold, _mul32


@functools.lru_cache(maxsize=None)
def kept_value(rate: float, dtype: torch.dtype) -> float:
    """What ``hash_keep_mask`` holds for a kept element: 1 / (1 - rate),
    divided in ``dtype`` (bf16 at rate 0.1: 1 / 0.8984375 -> 1.109375)."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(1.0 - rate, dtype=dtype))


def kernel_scalars(seed: int, rate: float, dtype: torch.dtype) -> tuple[int, int, float]:
    """(seed mod 2**32, keep threshold, kept value): K10's arguments. An
    element is kept when its hash is at or above the threshold."""
    return int(seed) & _M32, _keep_threshold(rate), kept_value(rate, dtype)


def index_map(shape, offset: int = 0, heads=None) -> tuple[int, int, int]:
    """(chunk, gap, offset) of K10's map from an element's flat index l in
    ``x`` to its index in the global tensor: l + (l // chunk) * gap + offset
    with the heads chunked, l + offset when chunk is 0. ``heads`` = (m, tp):
    ``x``'s dim 1 is chunk m of tp of the global tensor's, so each of its
    rows (chunk elements) sits (tp - 1) * chunk elements after the last,
    starting m * chunk into its global row."""
    if heads is None or heads[1] == 1:
        return 0, 0, offset
    m, tp = heads
    chunk = math.prod(shape[1:])
    return chunk, (tp - 1) * chunk, offset + m * chunk


def global_index(shape, offset: int = 0, heads=None) -> torch.Tensor:
    """(numel,) int64: each element's index in the global tensor, as K10
    computes it from ``index_map``."""
    chunk, gap, offset = index_map(shape, offset, heads)
    local = torch.arange(math.prod(shape), dtype=torch.int64)
    if chunk:
        local = local + (local // chunk) * gap
    return local + offset


def keep_hash_reference(index: torch.Tensor, seed32: int) -> torch.Tensor:
    """The murmur finalizer of (index * 0x9E3779B9) ^ (seed * 0xC2B2AE35),
    mod 2**32, in int64 arithmetic: ``ops/csrc/common.cuh::keep_hash(index,
    0, seed, 0)``."""
    h = _mul32(index & _M32, 0x9E3779B9) ^ ((seed32 * 0xC2B2AE35) & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_scale_reference(seed, shape, rate, dtype, offset=0, heads=None) -> torch.Tensor:
    """The mask K10 multiplies by, in ``dtype`` on the CPU: the kept value
    where an element is kept, 0 where it is dropped."""
    seed32, threshold, c = kernel_scalars(seed, rate, dtype)
    keep = keep_hash_reference(global_index(shape, offset, heads), seed32) >= threshold
    return torch.where(keep.reshape(shape), torch.tensor(c, dtype=dtype),
                       torch.zeros((), dtype=dtype))


def hash_dropout_reference(x, seed, rate, offset=0, heads=None) -> torch.Tensor:
    """Plain version of K10: ``x`` times the mask, one rounding to x's dtype."""
    return x * keep_scale_reference(seed, x.shape, rate, x.dtype, offset, heads).to(x.device)


def hash_dropout_kernel(x, seed, rate, offset=0, heads=None) -> torch.Tensor:
    """K10 on a CUDA tensor, bf16 or f32: one launch on the current stream."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"hash dropout kernel: dtype {x.dtype}, want bfloat16 or float32")
    x = x.contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel()
    if n == 0:
        return y
    chunk, gap, offset = index_map(x.shape, offset, heads)
    seed32, threshold, c = kernel_scalars(seed, rate, x.dtype)
    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.asr_hash_dropout(
            x.data_ptr(), y.data_ptr(), n, int(x.dtype == torch.bfloat16), chunk,
            gap & _M32, offset & _M32, seed32, threshold, c,
            torch.cuda.current_stream().cuda_stream,
        )
    check(err, "asr_hash_dropout")
    hash_dropout_kernel.launches += 1
    return y


def _dropout(x, seed, rate, offset, heads):
    if x.device.type == "cpu":
        return hash_dropout_reference(x, seed, rate, offset, heads)
    if x.device.type != "cuda":
        raise ValueError(f"hash dropout: unsupported device {x.device}")
    return hash_dropout_kernel(x, seed, rate, offset, heads)


class _HashDropout(torch.autograd.Function):
    """K10 forward and backward (plain versions on the CPU). Saves only the
    scalars: the backward hashes the same indices again."""

    @staticmethod
    def forward(ctx, x, seed, rate, offset, heads):
        ctx.args = (seed, rate, offset, heads)
        return _dropout(x, seed, rate, offset, heads)

    @staticmethod
    def backward(ctx, grad):
        return _HashDropout.apply(grad, *ctx.args), None, None, None, None


def hash_dropout(x, seed: int, rate: float, offset: int = 0, heads=None) -> torch.Tensor:
    """``x * hash_keep_mask(seed, x.shape, rate, x.dtype, x.device, offset)``
    bit for bit (with ``heads`` = (m, tp): times chunk m of tp along dim 1 of
    the mask of the global shape), without the mask. 0 <= rate < 1."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"hash dropout: rate {rate} not in [0, 1)")
    return _HashDropout.apply(x, int(seed), float(rate), int(offset), heads)


# kernel launches so far (the CPU path does not count)
hash_dropout_kernel.launches = 0
