"""K10's arithmetic on the CPU: the hash dropout kernel's arguments, its
map from a local element to its index in the global tensor, and its
autograd Function (the plain version on CPU tensors), each held bit for bit
to ``models/layers.py::hash_keep_mask`` or to the JAX package's
``ConfigurableDropout(impl="hash")``. The kernel itself runs on the card
(``chip_smoke.py``'s K10 gate)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.models.layers import ConfigurableDropout as JaxDropout
from asr_chinese_e2e_tpu_torch.models.layers import ConfigurableDropout, hash_keep_mask
from asr_chinese_e2e_tpu_torch.ops.fused_attention import _keep_threshold
from asr_chinese_e2e_tpu_torch.ops.hash_dropout import (
    global_index,
    hash_dropout,
    index_map,
    kernel_scalars,
    keep_hash_reference,
    keep_scale_reference,
)

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, torch.int32), "bfloat16": (torch.bfloat16, torch.int16)}


def bits(x: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns, every NaN as one: equal bits tell signed
    zeros apart where ``torch.equal`` cannot, and NaN equals NaN. (Torch's
    CPU multiply gives a NaN other payloads on other paths.)"""
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.contiguous().view(DTYPES[str(x.dtype).removeprefix("torch.")][1])


def special_values(shape, dtype, seed=0) -> torch.Tensor:
    """Normal values with signed zeros, NaN and infinities planted."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    flat = x.view(-1)
    flat[::7] = 0.0
    flat[3::7] = -0.0
    flat[5::11] = float("nan")
    flat[6::13] = float("inf")
    flat[2::17] = -float("inf")
    return x.to(dtype)


# -- (a) the kernel's arguments -------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arguments_equal_hash_keep_mask(dtype, rate):
    """The threshold, the seed term and the kept value K10 is given make
    ``hash_keep_mask``'s mask, bit for bit; the kept value is the mask's
    division in the dtype (bf16 at 0.1: 1.109375)."""
    dt = DTYPES[dtype][0]
    seed, shape = 1234567, (5, 6, 7)
    seed32, threshold, c = kernel_scalars(seed, rate, dt)
    assert seed32 == seed and threshold == _keep_threshold(rate)
    want = hash_keep_mask(seed, shape, rate, dt, "cpu")
    assert c == want.max().item() and want.min().item() == 0.0
    if dt == torch.bfloat16 and rate == 0.1:
        assert c == 1.109375
    assert c == float(torch.ones((), dtype=dt) / torch.tensor(1.0 - rate, dtype=dt))
    h = keep_hash_reference(global_index(shape), seed32)
    assert torch.equal((h >= threshold).reshape(shape), want != 0)
    assert torch.equal(bits(keep_scale_reference(seed, shape, rate, dt)), bits(want))


@pytest.mark.parametrize("seed", [0, 2**31 - 2, 2**32 + 5])
def test_seed_is_taken_mod_2_32(seed):
    """A seed past 32 bits hashes as its low 32 bits, as the mask's int64
    copy of ``seed & 0xFFFFFFFF`` does."""
    assert kernel_scalars(seed, 0.1, torch.float32)[0] == seed & 0xFFFFFFFF
    want = hash_keep_mask(seed, (4, 33), 0.1, torch.float32, "cpu")
    assert torch.equal(keep_scale_reference(seed, (4, 33), 0.1, torch.float32), want)


# -- (b) the index map ----------------------------------------------------------


@pytest.mark.parametrize("heads", [None, (0, 1), (1, 2), (2, 4), (0, 4)])
@pytest.mark.parametrize("offset", [0, 12345, 3 * 2**32 + 7])
def test_global_index_is_the_full_tensors(heads, offset):
    """Each local element's global index is its place in the full tensor
    (chunk m of tp along dim 1), plus the offset."""
    local = (3, 2, 5, 7)
    tp = 1 if heads is None else heads[1]
    full = (local[0], local[1] * tp, *local[2:])
    want = torch.arange(int(np.prod(full)), dtype=torch.int64).reshape(full)
    if tp > 1:
        want = want.chunk(tp, 1)[heads[0]]
    assert torch.equal(global_index(local, offset, heads), want.flatten() + offset)


@pytest.mark.parametrize("heads", [None, (1, 2), (2, 4)])
@pytest.mark.parametrize("offset", [0, 987654321])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_mask_equals_the_full_masks_chunk(dtype, heads, offset):
    """K10's mask of a local chunk equals ``hash_keep_mask`` of the full
    shape (at the full tensor's offset) chunked as ``ConfigurableDropout``
    chunks it; with no heads, the mask at the offset."""
    dt = DTYPES[dtype][0]
    local = (4, 2, 9, 11)
    tp = 1 if heads is None else heads[1]
    full = (local[0], local[1] * tp, *local[2:])
    want = hash_keep_mask(77, full, 0.1, dt, "cpu", offset)
    if tp > 1:
        want = want.chunk(tp, 1)[heads[0]]
    got = keep_scale_reference(77, local, 0.1, dt, offset, heads)
    assert torch.equal(bits(got), bits(want))


def kernel_loop_indices(n, vec, grid_threads, chunk, gap, offset) -> list:
    """The global index (mod 2**32) each element gets in K10's loop, in
    the kernel's own steps: thread t takes vectors t, t + grid_threads, ...
    of ``vec`` elements, carries (g, r) from the vector's first element
    (one 64-bit division), and the first n % vec threads take the scalar
    tail."""
    m32 = 0xFFFFFFFF
    out = [None] * n

    def start(l):
        if chunk:
            q = l // chunk
            return (l + q * gap + offset) & m32, l - q * chunk
        return (l + offset) & m32, 0

    for tid in range(grid_threads):
        for v in range(tid, n // vec, grid_threads):
            g, r = start(v * vec)
            for k in range(vec):
                out[v * vec + k] = g
                g = (g + 1) & m32
                if chunk:
                    r += 1
                    if r == chunk:
                        r, g = 0, (g + gap) & m32
        tail = n // vec * vec + tid
        if tail < n:
            out[tail] = start(tail)[0]
    return out


@pytest.mark.parametrize("vec", [8, 4, 1])
@pytest.mark.parametrize("heads", [None, (1, 2), (3, 4)])
@pytest.mark.parametrize("shape", [(3, 2, 5, 7), (2, 1, 3, 1), (1, 3, 1, 1)])
def test_kernel_loop_gives_the_global_index(shape, heads, vec):
    """K10's vectors, carries across row ends (rows shorter than a vector
    too) and scalar tail reproduce ``global_index`` mod 2**32, at an offset
    past 32 bits and with fewer threads than vectors (the launch gives at
    least 256 threads, more than any tail)."""
    offset = 2**32 + 99
    chunk, gap, off = index_map(shape, offset, heads)
    n = int(np.prod(shape))
    got = kernel_loop_indices(n, vec, 8, chunk, gap, off & 0xFFFFFFFF)
    assert got == (global_index(shape, offset, heads) & 0xFFFFFFFF).tolist()


# -- (c) the autograd Function on the CPU ---------------------------------------


@pytest.mark.parametrize("heads", [None, (1, 2)])
@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_forward_and_backward_equal_the_masks_product(dtype, rate, heads):
    """Forward x * mask and backward grad * mask bit for bit, signed zeros,
    NaN and infinities in both; an odd element count."""
    dt = DTYPES[dtype][0]
    local, seed, offset = (3, 2, 7, 13), 424242, 5 * 3 * 2 * 7 * 13
    tp = 1 if heads is None else heads[1]
    full = (local[0], local[1] * tp, *local[2:])
    mask = hash_keep_mask(seed, full, rate, dt, "cpu", offset)
    if tp > 1:
        mask = mask.chunk(tp, 1)[heads[0]]
    x = special_values(local, dt, seed=1).requires_grad_(True)
    grad = special_values(local, dt, seed=2)
    y = hash_dropout(x, seed, rate, offset, heads)
    y.backward(grad)
    assert y.dtype == dt and x.grad.dtype == dt
    assert torch.equal(bits(y.detach()), bits(x.detach() * mask))
    assert torch.equal(bits(x.grad), bits(grad * mask))


def test_function_saves_no_tensor():
    """The graph holds the scalars, not a mask."""
    x = torch.randn(8, 16, requires_grad=True)
    y = hash_dropout(x, 5, 0.1)
    assert y.grad_fn.saved_tensors == ()
    assert y.grad_fn.args == (5, 0.1, 0, None)


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_equals_jax(seed, dtype, monkeypatch):
    """The plain version equals the JAX module's hash dropout with its
    per-call seed pinned to ``seed``."""
    x = np.random.RandomState(3).randn(3, 7, 11).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(seed, jnp.int32))
    xj = jnp.asarray(x).astype(dtype)
    want = JaxDropout(0.1, "hash").apply(
        {}, xj, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    got = hash_dropout(torch.from_numpy(x).to(DTYPES[dtype][0]), seed, 0.1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("rate", [-0.1, 1.0])
def test_function_refuses_a_rate_outside_0_1(rate):
    with pytest.raises(ValueError, match="rate"):
        hash_dropout(torch.ones(4), 0, rate)


# -- (d) the identity cases -----------------------------------------------------


@pytest.mark.parametrize("impl", ["hash", "rng"])
def test_dropout_without_rng_or_rate_returns_x_itself(impl):
    x = torch.randn(4, 5)
    assert ConfigurableDropout(0.1, impl)(x, None) is x
    assert ConfigurableDropout(0.0, impl)(x, torch.Generator().manual_seed(0)) is x
