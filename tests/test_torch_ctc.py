"""The port's CTC against the JAX package's: the plain recursion
(``ops/ctc.py``, ``ctc_impl="scan"``) and the CPU path of the kernel
wrapper ``ctc_loss_kernel`` (the plain versions of K3/K4) against JAX's
``ctc_loss_pallas`` (Pallas interpret mode on the CPU) and ``ops/ctc.py``,
values and gradients, plus ``torch.nn.functional.ctc_loss`` as an extra
oracle. Cases follow ``tests/test_ctc_pallas.py``. Tolerances: rtol 1e-4
for losses; rtol 1e-3, atol 1e-4 for gradients (f32 recursions summed in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from asr_chinese_e2e_tpu.ops.ctc import ctc_loss as jax_ctc_loss
from asr_chinese_e2e_tpu.ops.ctc_pallas import ctc_loss_pallas as jax_ctc_loss_pallas
from asr_chinese_e2e_tpu_torch.ops.ctc import BIG_NEG, ctc_loss, extend_labels
from asr_chinese_e2e_tpu_torch.ops.ctc_kernel import (
    ctc_alpha_kernel,
    ctc_alpha_reference,
    ctc_beta_kernel,
    ctc_loss_kernel,
)

torch.set_num_threads(2)

VALUE_RTOL = 1e-4
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)


def make_case(seed, B=4, T=20, L=6, C=10, lens=None, label_lens=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, T, C).astype(np.float32)
    logit_lens = np.asarray(lens if lens is not None else [T] * B, np.int32)
    ll = np.asarray(label_lens if label_lens is not None else [L] * B, np.int32)
    labels = rng.randint(1, C, size=(B, L)).astype(np.int32)
    for b in range(B):
        labels[b, ll[b]:] = 0
    return logits, logit_lens, labels, ll


CASES = {
    "full": dict(seed=0),
    "ragged": dict(seed=0, lens=[20, 17, 12, 9], label_lens=[6, 4, 3, 1]),
    "label-lengths": dict(seed=0, lens=[20] * 4, label_lens=[6, 6, 1, 2]),
    "grad-ragged": dict(seed=1, lens=[20, 15, 20, 11], label_lens=[5, 3, 6, 2]),
    "odd-shapes": dict(seed=3, B=3, T=7, L=2, C=5),
    "empty-label": dict(seed=5, lens=[20, 13, 20, 8], label_lens=[6, 0, 2, 0]),
}
PORT_FNS = {"scan": ctc_loss, "kernel-cpu": ctc_loss_kernel}


def _jax_value_and_grad(fn, logits, lens, labels, ll, weights):
    def total(x):
        per_utt = fn(x, jnp.asarray(lens), jnp.asarray(labels), jnp.asarray(ll))
        return (per_utt * weights).sum(), per_utt

    (_, per_utt), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(logits)
    )
    return np.asarray(per_utt), np.asarray(grad)


def _port_value_and_grad(fn, logits, lens, labels, ll, weights):
    x = torch.tensor(logits, requires_grad=True)
    per_utt = fn(x, torch.from_numpy(lens), torch.from_numpy(labels), torch.from_numpy(ll))
    (per_utt * torch.from_numpy(np.asarray(weights, np.float32))).sum().backward()
    return per_utt.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("impl", list(PORT_FNS))
@pytest.mark.parametrize("case", list(CASES))
def test_ctc_matches_jax(case, impl):
    logits, lens, labels, ll = make_case(**CASES[case])
    w = np.ones(len(lens), np.float32)
    want_v, want_g = _jax_value_and_grad(jax_ctc_loss_pallas, logits, lens, labels, ll, w)
    got_v, got_g = _port_value_and_grad(PORT_FNS[impl], logits, lens, labels, ll, w)
    np.testing.assert_allclose(got_v, want_v, rtol=VALUE_RTOL)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)
    scan_v, _ = _jax_value_and_grad(jax_ctc_loss, logits, lens, labels, ll, w)
    np.testing.assert_allclose(got_v, scan_v, rtol=VALUE_RTOL)


@pytest.mark.parametrize("impl", list(PORT_FNS))
def test_weighted_cotangent_matches_jax(impl):
    logits, lens, labels, ll = make_case(2)
    w = np.asarray([1.0, 0.5, 2.0, 0.0], np.float32)
    _, want_g = _jax_value_and_grad(jax_ctc_loss, logits, lens, labels, ll, w)
    _, got_g = _port_value_and_grad(PORT_FNS[impl], logits, lens, labels, ll, w)
    np.testing.assert_allclose(got_g, want_g, **GRAD_TOL)


@pytest.mark.parametrize("impl", list(PORT_FNS))
def test_matches_torch_ctc_loss(impl):
    logits, lens, labels, ll = make_case(1, lens=[20, 15, 20, 11], label_lens=[5, 3, 6, 2])
    w = np.ones(4, np.float32)
    got_v, got_g = _port_value_and_grad(PORT_FNS[impl], logits, lens, labels, ll, w)
    x = torch.tensor(logits, requires_grad=True)
    want = F.ctc_loss(
        torch.log_softmax(x, -1).transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(lens).long(), torch.from_numpy(ll).long(),
        blank=0, reduction="none",
    )
    want.sum().backward()
    np.testing.assert_allclose(got_v, want.detach().numpy(), rtol=VALUE_RTOL)
    np.testing.assert_allclose(got_g, x.grad.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("impl", list(PORT_FNS))
def test_label_longer_than_logits_stays_finite(impl):
    logits, lens, labels, ll = make_case(6, B=2, T=8, L=6, lens=[8, 3], label_lens=[6, 5])
    v, g = _port_value_and_grad(PORT_FNS[impl], logits, lens, labels, ll, np.ones(2))
    assert np.all(np.isfinite(v)) and np.all(np.isfinite(g))
    assert v[1] > 1e29  # no alignment: the loss is log-zero's magnitude


def test_bf16_logits_select_exactly():
    """bf16 logits: the emission gather reads the exact bf16 values, so the
    plain K3 emissions equal the f32-cast logits gathered at the labels
    minus their log-sum-exp, bit for bit (no one-hot product); the
    gradient comes back in bf16."""
    logits, lens, labels, ll = make_case(9, B=2, T=6, L=2, C=7)
    x = torch.from_numpy(logits).to(torch.bfloat16)
    ext = extend_labels(torch.from_numpy(labels).long())
    loss, alpha, lse = ctc_alpha_reference(x, ext, torch.from_numpy(lens), torch.from_numpy(ll))
    x32 = x.float()[:, 0]
    want0 = x32.gather(1, ext) - torch.logsumexp(x32, -1, keepdim=True)
    got0 = torch.where(torch.arange(ext.shape[1]) <= 1, want0, torch.tensor(BIG_NEG))
    assert torch.equal(alpha[:, 0], got0)
    xg = x.clone().requires_grad_(True)
    ctc_loss_kernel(xg, torch.from_numpy(lens), torch.from_numpy(labels),
                    torch.from_numpy(ll)).sum().backward()
    assert xg.grad.dtype == torch.bfloat16
    want_v = np.asarray(jax_ctc_loss_pallas(
        jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(lens),
        jnp.asarray(labels), jnp.asarray(ll),
    ))
    np.testing.assert_allclose(loss.numpy(), want_v, rtol=VALUE_RTOL)


def test_kernel_wrappers_do_not_count_cpu_calls():
    logits, lens, labels, ll = make_case(0)
    before = (ctc_alpha_kernel.launches, ctc_beta_kernel.launches)
    x = torch.tensor(logits, requires_grad=True)
    ctc_loss_kernel(x, torch.from_numpy(lens), torch.from_numpy(labels),
                    torch.from_numpy(ll)).sum().backward()
    assert (ctc_alpha_kernel.launches, ctc_beta_kernel.launches) == before
