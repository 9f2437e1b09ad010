"""The plain version of the port's attention kernel against the JAX
package's fused attention kernel (Pallas interpret mode on the CPU), f32,
tolerance 1e-5 abs; the square entry point ``fused_attention``, forward
and gradients, against JAX's; and the index-hash keep mask, bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.ops.fused_attention import _xla_keep_mask
from asr_chinese_e2e_tpu.ops.fused_attention import fused_attention as jax_fused_attention
from asr_chinese_e2e_tpu.ops.fused_attention import (
    fused_attention_general as jax_fused_attention_general,
)
from asr_chinese_e2e_tpu_torch.ops.fused_attention import (
    _mul32,
    attention_reference,
    fused_attention,
    fused_attention_general,
    keep_mask_reference,
)

torch.set_num_threads(2)

TOL = 1e-5
# name: (Tq, Tk, causal, band, rate)
CASES = {
    "encoder": (24, 24, False, 0, 0.0),
    "causal": (24, 24, True, 0, 0.0),
    "band": (24, 24, False, 5, 0.0),
    "causal-band": (24, 24, True, 5, 0.0),
    "rectangular": (7, 29, False, 0, 0.0),
    "dropout": (24, 24, False, 0, 0.1),
    "causal-dropout": (20, 20, True, 0, 0.25),
}


def _inputs(tq, tk, seed=0, b=2, h=3, d=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    q_len = np.asarray([tq, max(1, tq - 9)], np.int32)
    k_len = np.asarray([tk, max(1, tk - 11)], np.int32)
    return q, k, v, q_len, k_len


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_jax_kernel(case):
    tq, tk, causal, band, rate = CASES[case]
    q, k, v, q_len, k_len = _inputs(tq, tk)
    seed, scale = 1234, 0.25
    want = jax_fused_attention_general(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_len),
        jnp.asarray(k_len), jnp.asarray(seed, jnp.int32), scale, rate, causal, band,
    )
    t = [torch.from_numpy(a) for a in (q, k, v, q_len, k_len)]
    got = attention_reference(*t, seed, scale, rate, causal, band)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_is_bit_exact(seed, rate):
    b, h, tq, tk = 2, 3, 17, 33
    want = np.asarray(_xla_keep_mask(jnp.asarray(seed, jnp.int32), b, h, tq, tk, rate))
    got = keep_mask_reference(seed, b, h, tq, tk, rate).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_mul32_wraps_like_uint32():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, size=1000, dtype=np.uint64)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F):
        want = (x.astype(np.uint32) * np.uint32(c)).astype(np.int64)
        got = _mul32(torch.from_numpy(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v, q_len, k_len = _inputs(12, 12)
    t = [torch.from_numpy(a) for a in (q, k, v, q_len, k_len)]
    before = fused_attention_general.launches
    got = fused_attention_general(*t, 0, 0.25, 0.0, False)
    want = attention_reference(*t, 0, 0.25, 0.0, False)
    assert torch.equal(got, want)
    assert fused_attention_general.launches == before


# -- the square entry point ------------------------------------------------------

SQUARE_SEED, SQUARE_SCALE = 99, 0.25


def _square(rate):
    """Port and JAX outputs of ``fused_attention`` at (2, 3, 24, 16) with
    ragged lengths, and the gradients of sum(out * g) on both sides."""
    q, k, v, lengths, _ = _inputs(24, 24, seed=3)
    g = np.random.RandomState(4).randn(*q.shape).astype(np.float32)

    def f(q, k, v):
        out = jax_fused_attention(q, k, v, jnp.asarray(lengths),
                                  jnp.asarray(SQUARE_SEED, jnp.int32), SQUARE_SCALE, rate)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), want_grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = fused_attention(*qkv, torch.from_numpy(lengths), SQUARE_SEED, SQUARE_SCALE, rate)
    (got * torch.from_numpy(g)).sum().backward()
    return (got.detach().numpy(), [t.grad.numpy() for t in qkv],
            np.asarray(want), [np.asarray(w) for w in want_grads])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_square_entry_matches_jax(rate):
    """Forward and backward (``torch.autograd`` against ``jax.grad``) of
    the square entry point; at rate 0.1 both draw the index-hash mask."""
    got, got_grads, want, want_grads = _square(rate)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for name, gg, ww in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(gg, ww, atol=TOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_square_entry_is_the_general_call_with_both_lengths(rate):
    q, k, v, lengths, _ = _inputs(20, 20, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v, lengths)]
    before = fused_attention_general.launches
    got = fused_attention(*t, 7, 0.3, rate)
    want = fused_attention_general(*t[:3], t[3], t[3], 7, 0.3, rate, False)
    assert torch.equal(got, want)
    assert fused_attention_general.launches == before
