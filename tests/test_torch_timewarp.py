"""The port's SpecAugment time-warp (``data/timewarp.py``) against the JAX
package's, on the CPU, on numpy-seeded inputs.

Both compute the same thin-plate spline. The JAX package solves and
evaluates it in the features' dtype, and in f32 that system (13 controls
and an affine part over distances of up to T frames) loses about 1e-5 of
the flow: its f32 warp is 1-2e-4 from its own float64 evaluation on
N(0, 1) features at T = 50. The port computes a warp's flow in float64.
So each function is held to JAX in float64 (under ``jax.enable_x64``) at
1e-9, which shows it is the same function, and in f32 at the bound that
JAX's f32 rounding leaves (stated per test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.data import timewarp as jt
from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.data.features import _spec_mask as jax_spec_mask
from asr_chinese_e2e_tpu.data.features import spec_augment as jax_spec_augment
from asr_chinese_e2e_tpu_torch.data import timewarp as tt
from asr_chinese_e2e_tpu_torch.data.features import (
    FeatureConfig,
    apply_spec_masks,
    parse_batch,
    spec_augment,
)

torch.set_num_threads(2)

W = 5  # warp param


def _feats(b=3, t=50, d=20, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, t, d).astype(dtype)
    lens = np.asarray([t, t - 13, 20, t - 1][:b], np.int32)
    feats *= np.arange(t)[None, :, None] < lens[:, None, None]
    return feats, lens


def _jax_draws(key, lens, warp_param=W):
    """JAX time_warp's centers and shifts for ``key`` (its own splits)."""
    k1, k2 = jax.random.split(key)
    lo = np.full(lens.shape, float(warp_param))
    hi = np.maximum(lens - warp_param, lo + 1.0)
    u = np.asarray(jax.random.uniform(k1, lens.shape))
    shifts = np.asarray(jax.random.randint(k2, lens.shape, -warp_param + 1, warp_param))
    return lo + u * (hi - lo), shifts


def _spline_case(seed=1, dtype=np.float64):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(9, 2) * [40, 20]).astype(dtype)
    vals = rng.randn(9, 3).astype(dtype)
    query = (rng.rand(30, 2) * [40, 20]).astype(dtype)
    return pts, vals, query


def test_interpolate_spline_matches_jax_float64():
    pts, vals, query = _spline_case()
    with jax.enable_x64(True):
        for q in (query, pts):
            want = np.asarray(jt.interpolate_spline(*(jnp.asarray(x) for x in (pts, vals, q))))
            got = tt.interpolate_spline(*(torch.from_numpy(x) for x in (pts, vals, q)))
            np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    # and exact at the controls
    got = tt.interpolate_spline(*(torch.from_numpy(x) for x in (pts, vals, pts)))
    np.testing.assert_allclose(got.numpy(), vals, atol=1e-9, rtol=0)


def test_interpolate_spline_matches_jax_float32_and_scipy():
    """f32 at the controls and the queries: within 1e-4 + 5e-5 relative of
    JAX (an f32 solve is ~1e-5 of the values' scale off them, measured; the
    queries extrapolate to 11), and the float64 port
    equals scipy's thin-plate RBF (the same order-2 polyharmonic basis and
    linear tail) within 1e-8."""
    from scipy.interpolate import RBFInterpolator

    pts, vals, query = _spline_case(dtype=np.float32)
    for q in (pts, query):
        want = np.asarray(jt.interpolate_spline(*(jnp.asarray(x) for x in (pts, vals, q))))
        got = tt.interpolate_spline(*(torch.from_numpy(x) for x in (pts, vals, q)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=5e-5)
    pts, vals, query = _spline_case()
    want = RBFInterpolator(pts, vals, kernel="thin_plate_spline")(query)
    got = tt.interpolate_spline(*(torch.from_numpy(x) for x in (pts, vals, query)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)


def test_dense_image_warp_matches_jax():
    """No solve: f32 within 1e-6, flows past the edges clamped as JAX's."""
    rng = np.random.RandomState(2)
    img = rng.randn(2, 30, 12).astype(np.float32)
    flow = (rng.randn(2, 30, 12, 2) * 4).astype(np.float32)
    want = np.stack([np.asarray(jt.dense_image_warp(jnp.asarray(i), jnp.asarray(f)))
                     for i, f in zip(img, flow)])
    got = tt.dense_image_warp(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert torch.equal(tt.dense_image_warp(torch.from_numpy(img[0]),
                                           torch.zeros(30, 12, 2)), torch.from_numpy(img[0]))


@pytest.mark.parametrize("boundary", [0, 1, 2, 3])
def test_sparse_image_warp_matches_jax(boundary):
    """Three moved controls (not on a line: the affine part needs them) and
    ``boundary`` anchors per edge: float64
    within 1e-9; f32 within 2e-4 (JAX's f32 spline); the anchors are JAX's, without
    duplicates."""
    rng = np.random.RandomState(3 + boundary)
    img = rng.randn(40, 16)
    src = np.asarray([[12.3, 7.5], [25.0, 3.0], [31.0, 12.0]])
    dst = src + [[3.0, 0.0], [-2.0, 1.5], [1.0, -1.0]]
    with jax.enable_x64(True):
        want = np.asarray(jt.sparse_image_warp(
            jnp.asarray(img), jnp.asarray(src), jnp.asarray(dst), boundary))
        got = tt.sparse_image_warp(
            torch.from_numpy(img), torch.from_numpy(src), torch.from_numpy(dst), boundary)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    f32 = [x.astype(np.float32) for x in (img, src, dst)]
    want = np.asarray(jt.sparse_image_warp(*(jnp.asarray(x) for x in f32), boundary))
    got = tt.sparse_image_warp(*(torch.from_numpy(x) for x in f32), boundary)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)
    pts = tt.boundary_points(40, 16, boundary)
    assert len(set(pts)) == len(pts) == 4 * (boundary + 1)


def test_time_warp_on_jax_draws_matches_jax():
    """JAX's drawn centers and shifts through the port's ``warp_at``:
    float64 within 1e-9 of JAX's ``time_warp``; f32 within 5e-4 (JAX's f32
    spline is 1-2e-4 off its float64 one on these N(0, 1) features,
    measured)."""
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(True):
        feats, lens = _feats(dtype=np.float64)
        want = np.asarray(jt.time_warp(jnp.asarray(feats), jnp.asarray(lens), key, W))
        centers, shifts = _jax_draws(key, lens)
        assert np.abs(shifts).max() > 0
        got = tt.warp_at(torch.from_numpy(feats), torch.from_numpy(lens),
                         torch.from_numpy(centers), torch.from_numpy(shifts))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)
    feats, lens = _feats()
    want = np.asarray(jt.time_warp(jnp.asarray(feats), jnp.asarray(lens), key, W))
    centers, shifts = _jax_draws(key, lens)
    got = tt.warp_at(torch.from_numpy(feats), torch.from_numpy(lens),
                     torch.from_numpy(centers.astype(np.float32)), torch.from_numpy(shifts))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_time_warp_keeps_padding_and_zero_param_is_a_no_op():
    feats, lens = _feats(b=4, seed=4)
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    out = tt.time_warp(x, n, torch.Generator().manual_seed(0), W)
    pad = np.arange(feats.shape[1])[None, :] >= lens[:, None]
    assert out.shape == x.shape and np.isfinite(out.numpy()).all()
    np.testing.assert_array_equal(out.numpy()[pad], feats[pad])
    assert not torch.equal(out, x)
    assert tt.time_warp(x, n, torch.Generator().manual_seed(0), 0) is x
    # a zero shift moves nothing
    same = tt.warp_at(x, n, torch.full((4,), 20.0), torch.zeros(4))
    np.testing.assert_allclose(same.numpy(), feats, atol=1e-4, rtol=0)


def test_draws_stay_in_range_and_come_from_the_generator():
    lens = torch.randint(3, 400, (4000,), generator=torch.Generator().manual_seed(1))
    centers, shifts = tt.draw_warps(torch.Generator().manual_seed(0), lens, W)
    hi = torch.maximum(lens.float() - W, torch.full_like(centers, W + 1.0))
    assert (centers >= W).all() and (centers < hi).all()
    assert shifts.min() == -W + 1 and shifts.max() == W - 1
    again = tt.draw_warps(torch.Generator().manual_seed(0), lens, W)
    assert torch.equal(again[0], centers) and torch.equal(again[1], shifts)


def test_batched_warp_equals_one_utterance_at_a_time():
    feats, lens = _feats(seed=5, dtype=np.float64)
    centers, shifts = np.asarray([20.5, 9.0, 14.25]), np.asarray([3, -4, 2])
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    batched = tt.warp_at(x, n, torch.from_numpy(centers), torch.from_numpy(shifts))
    for i in range(3):
        one = tt.warp_at(x[i:i + 1], n[i:i + 1], torch.from_numpy(centers[i:i + 1]),
                         torch.from_numpy(shifts[i:i + 1]))
        np.testing.assert_allclose(batched[i].numpy(), one[0].numpy(), atol=1e-12, rtol=0)


def test_spec_augment_warps_then_masks_as_jax():
    """JAX's spec_augment with a time warp, given its own draws (warp
    centers and shifts, masks) through the port's ``warp_at`` and
    ``apply_spec_masks``: float64 within 1e-9. The port's ``spec_augment``
    composes the same two stages from one generator."""
    kw = dict(num_freq_masks=1, num_time_masks=2, freq_mask_param=5, time_mask_param=8,
              num_time_warps=1, time_warp_param=W)
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        feats, lens = _feats(dtype=np.float64, seed=6)
        want = np.asarray(jax_spec_augment(jnp.asarray(feats), jnp.asarray(lens), key,
                                           JaxFeatureConfig(**kw)))
        rng, wkey = jax.random.split(key)
        _, sub = jax.random.split(wkey)
        centers, shifts = _jax_draws(sub, lens)
        keys = jax.random.split(rng, 3)
        jl = jnp.asarray(lens)
        freq = [torch.tensor(np.asarray(jax_spec_mask(keys[0], 3, 20, 5)))]
        time = [torch.tensor(np.asarray(jax_spec_mask(keys[1 + i], 3, 50, 8, jl)))
                for i in range(2)]
        x, n = torch.from_numpy(feats), torch.from_numpy(lens)
        warped = tt.warp_at(x, n, torch.from_numpy(centers), torch.from_numpy(shifts))
        got = apply_spec_masks(warped, n, freq, time)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-9, rtol=0)

    feats, lens = _feats(seed=6)
    x, n = torch.from_numpy(feats), torch.from_numpy(lens)
    cfg = FeatureConfig(**kw)
    got = spec_augment(x, n, cfg, torch.Generator().manual_seed(9))
    gen = torch.Generator().manual_seed(9)
    warped = tt.time_warp(x, n, gen, W)
    no_warp = FeatureConfig(**{**kw, "num_time_warps": 0})
    assert torch.equal(got, spec_augment(warped, n, no_warp, gen))


def test_parse_batch_augments_with_time_warp():
    """``parse_batch(augment=True)`` with ``num_time_warps`` > 0 warps, then
    masks: seeded, finite, zero past each length."""
    rng = np.random.RandomState(8)
    wave = (rng.randn(2, 8000) * 3000).astype(np.int16)
    lens = np.asarray([8000, 5200], np.int32)
    cfg = FeatureConfig(n_mels=20, num_time_warps=2, time_warp_param=3)
    outs = [parse_batch(torch.from_numpy(wave), torch.from_numpy(lens), cfg, augment=True,
                        generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    (a, a_len), (b, _), (c, _) = outs
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()
    pad = torch.arange(a.shape[1])[None, :] >= a_len[:, None]
    assert not a[pad].any()


def test_flow_is_float64_at_training_length():
    """At the training shape's 801 frames an f32 spline would lose up to
    2e-2 of the warped values (measured on the card); the port's f32 warp
    is its float64 warp up to the f32 resample: positions near frame 800
    rounded to 6e-5 frames, times these N(0, 1) features' slope of up to
    ~6 a frame, within 5e-4."""
    feats, _ = _feats(b=2, t=801, d=80, seed=9)
    lens = np.asarray([801, 640], np.int32)
    centers, shifts = torch.tensor([300.5, 512.25]), torch.tensor([4, -3])
    n = torch.from_numpy(lens)
    f32 = tt.warp_at(torch.from_numpy(feats), n, centers, shifts)
    f64 = tt.warp_at(torch.from_numpy(feats).double(), n, centers.double(), shifts)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), atol=5e-4, rtol=0)
