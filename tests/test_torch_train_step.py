"""The port's training pieces against the JAX package's: SpecAugment,
dropout, the teacher-forced forward, losses, schedules, clipping, and whole
train steps (the golden 3-step trajectory and grad_accum), on numpy-seeded
inputs and flax-converted weights, on the CPU. Tolerances are stated per
test (f32 throughout)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import _spec_mask as jax_spec_mask
from asr_chinese_e2e_tpu.data.features import spec_augment as jax_spec_augment
from asr_chinese_e2e_tpu.losses import hybrid_loss as jax_hybrid_loss
from asr_chinese_e2e_tpu.losses import model_loss as jax_model_loss
from asr_chinese_e2e_tpu.losses import smoothed_cross_entropy as jax_smoothed_ce
from asr_chinese_e2e_tpu.models.layers import ConfigurableDropout as JaxDropout
from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.train.optimizer import default_train_config as jax_train_config
from asr_chinese_e2e_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from asr_chinese_e2e_tpu.train.optimizer import make_schedule as jax_make_schedule
from asr_chinese_e2e_tpu.train.train_step import make_step_fns as jax_make_step_fns
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import (
    FeatureConfig,
    _spec_mask,
    apply_spec_masks,
    parse_batch,
)
from asr_chinese_e2e_tpu_torch.losses import (
    hybrid_loss,
    model_loss,
    smoothed_cross_entropy,
)
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.layers import (
    ConfigurableDropout,
    hash_keep_mask,
)
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
from asr_chinese_e2e_tpu_torch.train.optimizer import (
    clip_by_global_norm_,
    current_lr,
    default_train_config,
    make_optimizer,
    make_schedule,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns
from tests.test_golden import GOLDEN_LOSSES
from tests.test_transformer import tiny_cfg

torch.set_num_threads(2)

VOCAB = 20
ARGS = ("wave", "wave_lengths", "labels", "label_lengths")


# -- SpecAugment ---------------------------------------------------------------


def test_spec_augment_with_jax_masks_matches_jax():
    """JAX's own masks (same key splits as its spec_augment) applied by the
    port give JAX's output exactly."""
    cfg = JaxFeatureConfig(num_freq_masks=2, num_time_masks=2, freq_mask_param=6,
                           time_mask_param=9)
    rng = np.random.RandomState(0)
    b, t, d = 3, 40, 16
    feats = rng.randn(b, t, d).astype(np.float32)
    lens = np.asarray([40, 31, 12], np.int32)
    feats *= (np.arange(t)[None, :, None] < lens[:, None, None])
    key = jax.random.PRNGKey(5)
    want = jax_spec_augment(jnp.asarray(feats), jnp.asarray(lens), key, cfg)
    keys = jax.random.split(key, 4)
    freq = [np.asarray(jax_spec_mask(keys[i], b, d, 6)) for i in range(2)]
    time = [np.asarray(jax_spec_mask(keys[2 + i], b, t, 9, jnp.asarray(lens)))
            for i in range(2)]
    got = apply_spec_masks(
        torch.from_numpy(feats), torch.from_numpy(lens),
        [torch.tensor(m) for m in freq], [torch.tensor(m) for m in time],
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_spec_mask_draws_stay_in_range_and_are_uniform():
    gen = torch.Generator().manual_seed(0)
    b, dim, param = 4000, 100, 30
    lens = torch.randint(1, dim + 1, (b,), generator=torch.Generator().manual_seed(1))
    masks = _spec_mask(gen, b, dim, param, lens)
    width = masks.sum(1)
    assert int(width.max()) < param
    has = width > 0
    start = masks.int().argmax(1)
    end = start + width
    # the time mask starts inside the utterance (start < max(len - cap, 1))
    assert torch.all(start[has] < torch.clamp(lens[has], min=1))
    assert torch.all(end <= dim)
    # the cap is uniform on [0, param): chi-square over its draws
    caps = torch.stack([
        _uniform_cap(torch.Generator().manual_seed(s), param) for s in range(3)
    ]).flatten()
    counts = np.bincount(caps.numpy(), minlength=param)
    expected = len(caps) / param
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert counts.min() > 0 and chi2 < 70  # 29 dof: p(chi2 > 70) < 1e-4


def _uniform_cap(gen, param):
    from asr_chinese_e2e_tpu_torch.data.features import _uniform_int

    return _uniform_int(gen, torch.full((20000,), param, dtype=torch.int64))


def test_parse_batch_augment_needs_a_generator_and_is_seeded():
    rng = np.random.RandomState(0)
    wave = torch.from_numpy(rng.randint(-3000, 3000, (2, 8000)).astype(np.int16))
    lens = torch.tensor([8000, 5000])
    cfg = FeatureConfig(n_mels=20)
    with pytest.raises(ValueError, match="generator"):
        parse_batch(wave, lens, cfg, augment=True)
    a, _ = parse_batch(wave, lens, cfg, augment=True, generator=torch.Generator().manual_seed(4))
    b, _ = parse_batch(wave, lens, cfg, augment=True, generator=torch.Generator().manual_seed(4))
    c, _ = parse_batch(wave, lens, cfg)
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- dropout -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 12345, 2**31 - 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_is_bit_exact(seed, dtype, monkeypatch):
    """The JAX module draws its per-call seed with jax.random.randint;
    pinning that draw lets both sides hash the same seed."""
    x = np.random.RandomState(1).randn(3, 7, 11).astype(np.float32)
    monkeypatch.setattr(
        jax.random, "randint", lambda *a, **k: jnp.asarray(seed, jnp.int32)
    )
    mod = JaxDropout(0.1, "hash")
    xj = jnp.asarray(x).astype(dtype)
    want = mod.apply({}, xj, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = xt * hash_keep_mask(seed, xt.shape, 0.1, xt.dtype, "cpu")
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32))
    )


@pytest.mark.parametrize("impl", ["rng", "hash"])
def test_dropout_draws_from_its_generator_only(impl):
    drop = ConfigurableDropout(0.3, impl)
    x = torch.ones(50, 40)
    state = torch.random.get_rng_state()
    a = drop(x, torch.Generator().manual_seed(7))
    b = drop(x, torch.Generator().manual_seed(7))
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched
    assert torch.equal(a, b)
    kept = (a != 0).float().mean().item()
    assert 0.6 < kept < 0.8
    assert torch.equal(drop(x, None), x)


# -- model forward and losses --------------------------------------------------


def _model_pair(cfg, seed=0):
    jm = JaxModel(cfg, VOCAB)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, cfg.input_dim)), jnp.asarray([8]),
        jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]),
    )
    params = jax.tree.map(np.asarray, params)
    pcfg = Config(**cfg.to_dict())
    tm = SpeechTransformer(pcfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, pcfg, VOCAB))
    return jm, params, tm


def _batch(b=2, t=9, l=5, input_dim=12, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, input_dim).astype(np.float32)
    lens = np.asarray([t, t - 3, t - 1, t][:b], np.int32)
    label_lens = np.asarray([l, l - 2, l - 1, 2][:b], np.int32)
    labels = rng.randint(4, VOCAB, size=(b, l)).astype(np.int32)
    labels *= np.arange(l)[None, :] < label_lens[:, None]
    return {"wave": feats, "wave_lengths": lens, "labels": labels,
            "label_lengths": label_lens}


@pytest.mark.parametrize("decoder_attn_impl", ["xla", "fused"])
def test_teacher_forced_forward_and_model_loss_match_jax(decoder_attn_impl):
    cfg = tiny_cfg(dropout_rate=0.1, attn_impl="fused",
                   decoder_attn_impl=decoder_attn_impl, label_smoothing=0.1)
    jm, params, tm = _model_pair(cfg)
    batch = _batch()
    jin = [jnp.asarray(batch[k]) for k in ARGS]
    jout = jax.jit(jm.apply)(params, *jin)
    tout = tm(*(torch.from_numpy(batch[k]) for k in ARGS))
    for key in ("logits", "ctc_logits", "enc_out"):
        np.testing.assert_allclose(tout[key].detach().numpy(), np.asarray(jout[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    assert torch.equal(tout["gold"], torch.from_numpy(np.asarray(jout["gold"])).to(tout["gold"].dtype))
    for impl in ("pallas", "scan"):
        loss_fn = jax.jit(lambda o, lab, ll: jax_model_loss(o, lab, ll, 0.3, 0.1, impl))
        _, jm_metrics = loss_fn(jout, jin[2], jin[3])
        _, tm_metrics = model_loss(tout, torch.from_numpy(batch["labels"]),
                                   torch.from_numpy(batch["label_lengths"]), 0.3, 0.1, impl)
        for k, v in jm_metrics.items():
            np.testing.assert_allclose(float(tm_metrics[k].detach()), float(v), rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_smoothed_cross_entropy_matches_jax(smoothing):
    rng = np.random.RandomState(3)
    logits = rng.randn(3, 6, 13).astype(np.float32) * 3
    targets = rng.randint(0, 13, size=(3, 6)).astype(np.int32)
    targets[:, 4:] = 0
    want, want_n = jax_smoothed_ce(jnp.asarray(logits), jnp.asarray(targets), smoothing)
    got, got_n = smoothed_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                        smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert int(got_n) == int(want_n)


def test_hybrid_loss_matches_jax():
    rng = np.random.RandomState(4)
    ce_logits = rng.randn(2, 5, 11).astype(np.float32)
    gold = np.asarray([[3, 4, 5, 3, 0], [6, 3, 0, 0, 0]], np.int32)
    ctc_logits = rng.randn(2, 9, 11).astype(np.float32)
    lens = np.asarray([9, 7], np.int32)
    labels = np.asarray([[4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    label_lens = np.asarray([2, 1], np.int32)
    args = (ce_logits, gold, ctc_logits, lens, labels, label_lens)
    want_loss, want = jax_hybrid_loss(*(jnp.asarray(a) for a in args), 0.3, 0.1)
    got_loss, got = hybrid_loss(*(torch.from_numpy(a) for a in args), 0.3, 0.1)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


# -- schedules and clipping ----------------------------------------------------


@pytest.mark.parametrize("overrides", [
    dict(lr_schedule="noam", warmup=10, noam_factor=2.0),
    dict(lr_schedule="anneal", lr=1e-3, anneal_factor=1.5, anneal_every=7),
    dict(lr_schedule="constant", lr=2e-4),
])
def test_schedules_match_jax(overrides):
    jcfg = jax_train_config().build(**overrides)
    pcfg = default_train_config().build(**overrides)
    jsched, psched = jax_make_schedule(jcfg, 64), make_schedule(pcfg, 64)
    for step in range(51):
        np.testing.assert_allclose(psched(step), float(jsched(jnp.asarray(step))),
                                   rtol=1e-6)
        assert current_lr(pcfg, 64, step) == psched(step)
    if overrides["lr_schedule"] == "noam":  # update 0 runs at Noam step 1
        assert psched(0) == pytest.approx(2.0 * 64 ** -0.5 * 10 ** -1.5)


@pytest.mark.parametrize("scale", [0.1, 1.0, 3.0])
def test_clip_matches_optax(scale):
    rng = np.random.RandomState(0)
    grads = [rng.randn(*s).astype(np.float32) * scale for s in ((4, 5), (7,), (2, 3, 2))]
    max_norm = 5.0
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm_(tg, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w, orig in zip(tg, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
        if float(norm) < max_norm:
            assert np.array_equal(g.numpy(), orig)  # below the bound: untouched


# -- whole steps ---------------------------------------------------------------


def _jax_run(cfg, batch, n_steps, overrides=None):
    tcfg = jax_train_config().combine(cfg).build(rng_impl="threefry2x32", **(overrides or {}))
    jm = JaxModel(cfg, VOCAB)
    init_fn, train_step, _ = jax_make_step_fns(
        jm, jax_make_optimizer(tcfg, cfg.d_model), JaxFeatureConfig(), tcfg,
        raw_features=True,
    )
    state = init_fn(jax.random.PRNGKey(42), batch)
    params = jax.tree.map(np.asarray, state.params)
    args = [jnp.asarray(batch[k]) for k in ARGS]
    losses, norms = [], []
    for _ in range(n_steps):
        state, m = train_step(state, *args, jax.random.key(42, impl="threefry2x32"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, losses, norms, state


def _port_run(cfg, params, batch, n_steps, overrides=None):
    pcfg = Config(**cfg.to_dict())
    tm = SpeechTransformer(pcfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, pcfg, VOCAB))
    tcfg = default_train_config().combine(pcfg).build(**(overrides or {}))
    with pytest.warns(UserWarning, match="Noam peak"):
        opt = make_optimizer(tm.parameters(), tcfg, pcfg.d_model)
    init_fn, train_step, _ = make_step_fns(tm, opt, FeatureConfig(), tcfg, raw_features=True)
    state = init_fn()
    args = [torch.from_numpy(batch[k]) for k in ARGS]
    losses, norms = [], []
    for _ in range(n_steps):
        state, m = train_step(state, *args, 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return tm, losses, norms, state


def test_golden_three_step_trajectory():
    """From the converted JAX init of tests/test_golden.py's tiny model, the
    port's losses match GOLDEN_LOSSES (rtol 2e-4) and JAX's own run."""
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    rng = np.random.RandomState(42)
    batch = {
        "wave": rng.randn(2, 9, 12).astype(np.float32),
        "wave_lengths": np.array([9, 6], np.int32),
        "labels": np.array([[5, 6, 7, 0, 0], [8, 9, 0, 0, 0]], np.int32),
        "label_lengths": np.array([3, 2], np.int32),
    }
    params, j_losses, j_norms, jstate = _jax_run(cfg, batch, 3)
    tm, losses, norms, state = _port_run(cfg, params, batch, 3)
    np.testing.assert_allclose(losses, GOLDEN_LOSSES, rtol=2e-4)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    want = torch_state_from_flax(jax.tree.map(np.asarray, jstate.params), tm.cfg, VOCAB)
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
    assert state.step == 3 and state.optimizer.count == 3
    assert float(state.metric_sums["_n"]) == 6.0
    np.testing.assert_allclose(float(state.metric_sums["loss"]) / 6.0, np.mean(losses),
                               rtol=1e-5)


STEP_CONFIGS = {
    "conformer": dict(encoder_type="conformer", norm_type="pre", conv_kernel_size=5),
    "conformer-conv2d": dict(encoder_type="conformer", norm_type="pre", conv_kernel_size=4,
                             frontend="conv2d", attn_impl="fused"),
    "conformer-remat": dict(encoder_type="conformer", norm_type="pre", conv_kernel_size=5,
                            remat=True),
    "transformer-remat": dict(remat=True),
}


@pytest.mark.parametrize("name", list(STEP_CONFIGS))
def test_three_steps_match_jax(name):
    """3 train steps at dropout 0, CTC 0.3 from the converted JAX init: the
    losses within rtol 1e-5 and the updated weights within 1e-5 of JAX's
    (``remat`` on both sides where set)."""
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3, **STEP_CONFIGS[name])
    batch = _batch(t=13)
    params, j_losses, j_norms, jstate = _jax_run(cfg, batch, 3)
    tm, losses, norms, _ = _port_run(cfg, params, batch, 3)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    want = torch_state_from_flax(jax.tree.map(np.asarray, jstate.params), tm.cfg, VOCAB)
    assert want.keys() == tm.state_dict().keys()
    for key, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[key].numpy(), atol=1e-5, err_msg=key)


def test_grad_accum_matches_jax():
    cfg = tiny_cfg(dropout_rate=0.0, ctc_weight=0.3)
    batch = _batch(b=4)
    over = {"grad_accum": 2}
    params, j_losses, j_norms, _ = _jax_run(cfg, batch, 2, over)
    _, losses, norms, state = _port_run(cfg, params, batch, 2, over)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(norms, j_norms, rtol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        _port_run(cfg, params, _batch(b=3), 1, over)


def test_bf16_compute_keeps_f32_master_weights():
    """A bf16 model trains with float32 weights and Adam moments: an update
    far below bf16's resolution still moves the weights."""
    cfg = tiny_cfg(dropout_rate=0.1, dtype="bfloat16", dropout_impl="hash")
    pcfg = Config(**cfg.to_dict())
    tm = SpeechTransformer(pcfg, VOCAB)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tcfg = default_train_config().combine(pcfg).build(lr_schedule="constant", lr=1e-6)
    opt = make_optimizer(tm.parameters(), tcfg, pcfg.d_model)
    init_fn, train_step, _ = make_step_fns(tm, opt, FeatureConfig(), tcfg, raw_features=True)
    state = init_fn()
    batch = _batch()
    out = tm(*(torch.from_numpy(batch[k]) for k in ARGS))
    assert out["ctc_logits"].dtype == torch.bfloat16 and out["logits"].dtype == torch.float32
    state, m = train_step(state, *(torch.from_numpy(batch[k]) for k in ARGS), 0)
    assert np.isfinite(float(m["loss"]))
    w = tm.encoder.layers[0].ffn.w1.weight
    assert w.dtype == torch.float32
    moved = (w - before["encoder.layers.0.ffn.w1.weight"]).abs()
    assert 0 < float(moved.max()) < 1e-5  # an Adam step of ~lr, lost in bf16
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.adam.state.values())
