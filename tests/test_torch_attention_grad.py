"""Gradients of the port's fused attention against the JAX package's: the
plain backward ``attention_backward_reference`` (the CPU path of K2, through
the autograd Function) against ``jax.grad`` of JAX's
``fused_attention_general`` (its Pallas backward kernel in interpret mode on
the CPU), f32, 1e-5 abs; and a float64 ``gradcheck`` of the Function's CPU
path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.ops.fused_attention import (
    fused_attention_general as jax_fused_attention_general,
)
from asr_chinese_e2e_tpu_torch.ops.fused_attention import (
    attention_backward_kernel,
    attention_backward_reference,
    fused_attention_general,
)

torch.set_num_threads(2)

TOL = 1e-5
# name: (Tq, Tk, causal, band, rate)
CASES = {
    "square-ragged": (40, 40, False, 0, 0.0),
    "causal": (33, 33, True, 0, 0.0),
    "band": (36, 36, False, 4, 0.0),
    "causal-band": (30, 30, True, 6, 0.0),
    "rectangular": (9, 37, False, 0, 0.0),
    "dropout": (40, 40, False, 0, 0.1),
}
SEED, SCALE = 4321, 0.25


def _inputs(tq, tk, seed=0, b=2, h=2, d=16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for t in (tq, tk, tk))
    g = rng.randn(b, h, tq, d).astype(np.float32)
    q_len = np.asarray([tq, max(1, tq - 9)], np.int32)
    k_len = np.asarray([tk, max(1, tk - 13)], np.int32)
    return q, k, v, g, q_len, k_len


def _jax_grads(q, k, v, g, q_len, k_len, causal, band, rate):
    def f(q, k, v):
        out = jax_fused_attention_general(
            q, k, v, jnp.asarray(q_len), jnp.asarray(k_len),
            jnp.asarray(SEED, jnp.int32), SCALE, rate, causal, band,
        )
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    )]


@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax_kernel(case):
    tq, tk, causal, band, rate = CASES[case]
    q, k, v, g, q_len, k_len = _inputs(tq, tk)
    want = _jax_grads(q, k, v, g, q_len, k_len, causal, band, rate)
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    before = attention_backward_kernel.launches
    out = fused_attention_general(
        tq_, tk_, tv_, torch.from_numpy(q_len), torch.from_numpy(k_len),
        SEED, SCALE, rate, causal, band,
    )
    out.backward(torch.from_numpy(g))
    for got, ref in zip((tq_.grad, tk_.grad, tv_.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL, rtol=0)
    # padded query rows get no gradient, and the CPU path launches nothing
    assert torch.all(tq_.grad[1, :, q_len[1]:] == 0)
    assert attention_backward_kernel.launches == before
    # the explicit formula, called directly, is what the Function ran
    direct = attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, q_len, k_len)),
        SEED, SCALE, rate, causal, band, torch.from_numpy(g),
    )
    for got, ref in zip(direct, (tq_.grad, tk_.grad, tv_.grad)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("causal,band,rate", [(False, 0, 0.0), (True, 3, 0.2)])
def test_gradcheck_float64(causal, band, rate):
    rng = np.random.RandomState(1)
    b, h, tq, tk, d = 2, 1, 6, 7, 4
    q, k, v = (
        torch.tensor(rng.randn(b, h, t, d), dtype=torch.float64, requires_grad=True)
        for t in (tq, tk, tk)
    )
    q_len, k_len = torch.tensor([6, 4]), torch.tensor([7, 3])

    def f(q, k, v):
        return fused_attention_general(q, k, v, q_len, k_len, 9, 0.5, rate, causal, band)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_backward_over_keyless_rows_matches_jax_kernel(rate):
    """Causal band 20 with k_len [40, 9]: the rows past 59 and past 28 see
    no key, weigh every key alike, and take their gradient as the JAX
    package's ``_bwd_kernel`` gives it (K2 on the card rebuilds those rows
    from the row max and log-sum that K1 saves apart). T = 128: the JAX
    kernel pads its key tile to max(8-aligned Tk, 128) and averages such a
    row over the padded tile, where its ``_xla_attention`` and the port
    average over Tk (the difference inside the reference that ROADMAP §3
    records for k_len = 0); at Tk = 128 the two are the same."""
    q, k, v, g, _, _ = _inputs(128, 128, seed=7)
    q_len, k_len = np.asarray([128, 128], np.int32), np.asarray([40, 9], np.int32)
    want = _jax_grads(q, k, v, g, q_len, k_len, True, 20, rate)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fused_attention_general(
        *leaves, torch.from_numpy(q_len), torch.from_numpy(k_len), SEED, SCALE, rate, True, 20,
    )
    out.backward(torch.from_numpy(g))
    for got, ref in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), ref, atol=TOL, rtol=0)
    # the keyless rows reach every key, those past k_len too
    assert torch.all(leaves[2].grad[1, :, 9:].abs().sum(-1) > 0)
