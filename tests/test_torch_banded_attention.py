"""The plain versions of the port's windowed causal-band attention (K6/K7)
against the JAX package's windowed Pallas kernels (interpret mode on the
CPU, ``ASR_BANDED_WINDOW=1``): forward within 2e-5 abs and ``jax.grad``
within 2e-4 abs, JAX's own tolerances for these kernels; the windowed plain
version against the full-tile one; the route predicate against JAX's; and
three train steps of a causal-banded model on the windowed route against
JAX's ``make_step_fns`` (rtol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.ops import fused_attention as jfa
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa
from tests.test_torch_train_step import _jax_run, _port_run
from tests.test_transformer import tiny_cfg

torch.set_num_threads(2)

FWD_TOL, GRAD_TOL = 2e-5, 2e-4
SCALE = 0.2
# name: (T, band, lengths, rate, seed); (B, H, D) = (2, 2, 8)
CASES = {
    "band30": (150, 30, [150, 97], 0.0, 0),
    "band64": (150, 64, [150, 97], 0.0, 0),
    "band65": (150, 65, [150, 97], 0.0, 0),
    "band20-dropout": (100, 20, [100, 77], 0.15, 5),
}


def _inputs(t, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 2, t, 8).astype(np.float32) for _ in range(4)]  # q k v g


def _jax_window(q, k, v, g, lengths, band, rate, seed):
    """JAX's windowed route: output and grads of sum(out * g)."""
    lens = jnp.asarray(lengths, jnp.int32)

    def f(a, b, c):
        return jfa.fused_attention_general(
            a, b, c, lens, lens, jnp.asarray(seed, jnp.int32), SCALE, rate, True, band
        )

    args = [jnp.asarray(x) for x in (q, k, v)]
    grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * jnp.asarray(g)),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(f(*args)), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("case", list(CASES))
def test_window_matches_jax_kernel(case, monkeypatch):
    monkeypatch.setenv("ASR_BANDED_WINDOW", "1")
    t, band, lengths, rate, seed = CASES[case]
    q, k, v, g = _inputs(t)
    want, want_grads = _jax_window(q, k, v, g, lengths, band, rate, seed)
    lens = torch.tensor(lengths, dtype=torch.int32)
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    before = (fa.banded_attention_kernel.launches, fa.fused_attention_general.launches)
    out = fa.fused_attention_general(*leaves, lens, lens, seed, SCALE, rate, True, band)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=FWD_TOL, rtol=0)
    for leaf, ref in zip(leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, atol=GRAD_TOL, rtol=0)
    # the CPU path launches nothing
    assert (fa.banded_attention_kernel.launches,
            fa.fused_attention_general.launches) == before
    # the Function ran the plain versions, called directly here
    plain = [torch.from_numpy(x) for x in (q, k, v)]
    direct = fa.banded_attention_reference(*plain, lens, seed, SCALE, rate, band)
    assert torch.equal(direct, out.detach())
    grads = fa.banded_attention_backward_reference(
        *plain, lens, seed, SCALE, rate, band, torch.from_numpy(g)
    )
    for got, leaf in zip(grads, leaves):
        assert torch.equal(got, leaf.grad)


@pytest.mark.parametrize("case", list(CASES))
def test_window_matches_full_tile(case):
    """The windowed plain version equals the full-tile one with the causal
    band (same keep mask at global indices), forward and gradients."""
    t, band, lengths, rate, seed = CASES[case]
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(t, seed=1))
    lens = torch.tensor(lengths, dtype=torch.int32)
    win = fa.banded_attention_reference(q, k, v, lens, seed, SCALE, rate, band)
    full = fa.attention_reference(q, k, v, lens, lens, seed, SCALE, rate, True, band)
    torch.testing.assert_close(win, full, atol=1e-6, rtol=0)
    win_g = fa.banded_attention_backward_reference(q, k, v, lens, seed, SCALE, rate, band, g)
    full_g = fa.attention_backward_reference(
        q, k, v, lens, lens, seed, SCALE, rate, True, band, g
    )
    for a, b in zip(win_g, full_g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("env", ["0", "1", None])
def test_route_predicate_matches_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("ASR_BANDED_WINDOW", raising=False)
    else:
        monkeypatch.setenv("ASR_BANDED_WINDOW", env)
    for causal in (False, True):
        for band in (0, 1, 50, 64, 65):
            for tk in (20, 31):
                tq = torch.zeros(1, 1, 20, 4)
                jq = jnp.zeros((1, 1, 20, 4))
                got = fa._use_banded_window(tq, torch.zeros(1, 1, tk, 4), causal, band)
                want = jfa._use_banded_window(jq, jnp.zeros((1, 1, tk, 4)), causal, band)
                assert bool(got) == bool(want), (causal, band, tk)
        assert fa._block_q(band) == jfa._block_q(band)


def test_block_q():
    assert [fa._block_q(b) for b in (1, 50, 64, 65, 128, 129)] == [
        64, 64, 64, 128, 128, 192]


def test_gradcheck_float64_window(monkeypatch):
    """The windowed route's CPU backward is the gradient of its forward."""
    monkeypatch.setenv("ASR_BANDED_WINDOW", "1")
    rng = np.random.RandomState(2)
    q, k, v = (torch.tensor(rng.randn(2, 1, 70, 4), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    lens = torch.tensor([70, 45])

    def f(q, k, v):
        return fa.fused_attention_general(q, k, v, lens, lens, 9, 0.5, 0.2, True, 6)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


def test_three_train_steps_on_the_window_match_jax(monkeypatch):
    """A tiny pre-LN causal-band model (band 12, the fused route) trained
    three steps with the window on: losses, gradient norms and updated
    weights match JAX's ``make_step_fns`` under the same switch."""
    monkeypatch.setenv("ASR_BANDED_WINDOW", "1")
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3, attn_impl="fused",
                   norm_type="pre", causal_encoder=True, attention_band=12)
    rng = np.random.RandomState(7)
    batch = {
        "wave": rng.randn(2, 70, 12).astype(np.float32),
        "wave_lengths": np.array([70, 53], np.int32),
        "labels": np.array([[5, 6, 7, 0, 0], [8, 9, 0, 0, 0]], np.int32),
        "label_lengths": np.array([3, 2], np.int32),
    }
    params, j_losses, j_norms, jstate = _jax_run(cfg, batch, 3)
    calls = []
    for name in ("banded_attention_reference", "banded_attention_backward_reference"):
        fn = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _fn=fn, _n=name: calls.append(_n) or _fn(*a))
    tm, losses, norms, _ = _port_run(cfg, params, batch, 3)
    # every encoder self-attention took the windowed route: 2 layers x 3 steps
    assert calls.count("banded_attention_reference") == 6
    assert calls.count("banded_attention_backward_reference") == 6
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    want = torch_state_from_flax(jax.tree.map(np.asarray, jstate.params), tm.cfg,
                                 tm.vocab_size)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype,band,t,fits", [
    (torch.bfloat16, 704, 1500, True),    # twelve resident tiles
    (torch.bfloat16, 705, 1500, False),   # fourteen
    (torch.bfloat16, 769, 1500, False),
    (torch.bfloat16, 769, 768, True),     # no more tiles than T holds
    (torch.bfloat16, 769, 769, False),
    (torch.bfloat16, 50, 267, True),
    (torch.float32, 769, 1500, True),     # the FMA kernels serve any band
    (torch.float32, 2000, 4000, True),
])
def test_wide_band_route_decision(dtype, band, t, fits):
    assert fa._window_fits(torch.zeros(1, 1, t, 8, dtype=dtype), band) == fits


def test_wide_band_full_tile_equals_the_window():
    """A window too wide for K6/K7 takes the full-tile route with the causal
    band and ``k_lengths`` as both lengths: that plain path equals the
    windowed plain version at band 769, T = 1500, dropout 0.1 (f32)."""
    t, band, rate, seed = 1500, 769, 0.1, 11
    rng = np.random.RandomState(4)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 2, t, 16).astype(np.float32))
                  for _ in range(4))
    lens = torch.tensor([1337], dtype=torch.int32)
    win = fa.banded_attention_reference(q, k, v, lens, seed, SCALE, rate, band)
    full = fa.attention_reference(q, k, v, lens, lens, seed, SCALE, rate, True, band)
    torch.testing.assert_close(full, win, atol=1e-5, rtol=0)
    win_g = fa.banded_attention_backward_reference(q, k, v, lens, seed, SCALE, rate, band, g)
    full_g = fa.attention_backward_reference(
        q, k, v, lens, lens, seed, SCALE, rate, True, band, g)
    for a, b in zip(full_g, win_g):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_wide_bf16_window_takes_the_full_tile_route(monkeypatch):
    """Through the autograd Function: a bf16 call whose window does not fit
    runs the full-tile version with ``k_lengths`` for both lengths (the
    q_lengths passed are not used), a fitting one the windowed version."""
    monkeypatch.setenv("ASR_BANDED_WINDOW", "1")
    calls = []
    for name in ("attention_reference", "banded_attention_reference"):
        real = getattr(fa, name)

        def spy(*a, _real=real, _name=name):
            calls.append((_name, a[3].tolist()))
            return _real(*a)

        monkeypatch.setattr(fa, name, spy)
    q = torch.zeros(1, 1, 1500, 8, dtype=torch.bfloat16)
    k_len, q_len = torch.tensor([1400]), torch.tensor([1500])
    fa.fused_attention_general(q, q, q, q_len, k_len, 1, 0.5, 0.1, True, 769)
    fa.fused_attention_general(q, q, q, q_len, k_len, 1, 0.5, 0.1, True, 704)
    assert calls == [("attention_reference", [1400]), ("banded_attention_reference", [1400])]
