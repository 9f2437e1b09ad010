"""CPU rehearsal of the joint search's CTC prefix registers kernel as a warp
scan (K8, ``ops/csrc/ctc_prefix.cu``): an f32 numpy emulation of what each
of a warp's 32 lanes does, held against the plain version
``ctc_selected_registers_reference`` and against the JAX package's
``_ctc_selected_registers``.

What the emulation keeps of the kernel (one warp per hypothesis, every
hypothesis at once here):
- frames 1 .. T-1 cut into 32 contiguous chunks of ceil((T - 1) / 32), lane
  l taking chunk l (empty past the end);
- each lane composes its chunk's valid frames into one affine map of the
  state (nb, bb) in the log semiring, nb' = lae(a + nb, e), bb' = lae(lae(c
  + nb, d + bb), f), a frame folded in as the kernel folds it (an invalid
  frame is the identity);
- the inclusive scan of the 32 maps by shuffle-up over 1, 2, 4, 8, 16
  (lane l composes its map after lane l - off's where l >= off);
- each lane applies the scan of the lanes before it to the frame-0 state,
  clamps the carry at LOG_ZERO, and replays its chunk with the plain
  recursion from there.
lae is the kernel's max + log1p(exp(-|a - b|)) in float32.

Tolerances, the bounds ``chip_smoke.py`` holds the kernel to on the card:
1e-5 of max(1, |plain|) on the cells the plain version reaches, log-zero
(<= LOG_ZERO) on both sides on the others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode import joint as jax_joint
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_kernel as k8

torch.set_num_threads(2)

F32 = np.float32
LZ = F32(k8.LOG_ZERO)
LANES = 32
REL = 1e-5


def lae(a, b):
    m = np.maximum(a, b)
    return (m + np.log1p(np.exp(-np.abs(a - b)))).astype(F32)


def identity(shape):
    z, lz = np.zeros(shape, F32), np.full(shape, LZ)
    return [z, lz, z.copy(), lz.copy(), lz.copy()]


def compose(later, earlier):
    """``later`` applied after ``earlier``; maps as [a, c, d, e, f]."""
    la, lc, ld, le, lf = later
    ea, ec, ed, ee, ef = earlier
    return [la + ea, lae(lc + ea, ld + ec), ld + ed, lae(la + ee, le),
            lae(lae(lc + ee, ld + ef), lf)]


def scan_registers(flat, mask, r_nb_g, r_b_g, token, last, empty):
    """K8's lanes in numpy f32. Inputs as the plain version's (numpy);
    returns (r_nb, r_b), (B, K, T)."""
    b, k = token.shape
    t_max = flat.shape[1]
    c = flat.shape[0] // b
    xs = flat[np.arange(b)[:, None] * c + token]  # (B, K, T)
    bl = np.broadcast_to(flat[np.arange(b) * c][:, None, :], xs.shape)
    fm = np.broadcast_to(mask[:, None, :], xs.shape)
    phi = np.where((token == last)[..., None], r_b_g, lae(r_b_g, r_nb_g))
    chunk = (t_max - 1 + LANES - 1) // LANES
    bounds = []
    maps = []
    for lane in range(LANES):
        lo = min(1 + lane * chunk, t_max)
        hi = min(lo + chunk, t_max)
        bounds.append((lo, hi))
        a, cc, d, e, f = identity((b, k))
        for t in range(lo, hi):
            x, bt, ph = xs[..., t], bl[..., t], phi[..., t - 1]
            new = [x + a, lae(bt + a, bt + cc), bt + d, lae(x + e, ph + x), lae(bt + e, bt + f)]
            a, cc, d, e, f = (np.where(fm[..., t], n, o) for n, o in zip(new, (a, cc, d, e, f)))
        maps.append([a, cc, d, e, f])
    for off in (1, 2, 4, 8, 16):
        maps = [compose(maps[i], maps[i - off]) if i >= off else maps[i] for i in range(LANES)]
    nb0 = np.where(empty & fm[..., 0], xs[..., 0], LZ).astype(F32)
    r_nb = np.empty(xs.shape, F32)
    r_b = np.empty(xs.shape, F32)
    r_nb[..., 0], r_b[..., 0] = nb0, LZ
    for lane, (lo, hi) in enumerate(bounds):
        pa, pc, pd, pe, pf = identity((b, k)) if lane == 0 else maps[lane - 1]
        nb = np.maximum(lae(pa + nb0, pe), LZ)
        bb = np.maximum(lae(lae(pc + nb0, pd + LZ), pf), LZ)
        for t in range(lo, hi):
            x, ph = xs[..., t], phi[..., t - 1]
            nb_new = lae(nb + x, ph + x)
            bb_new = lae(bb, nb) + bl[..., t]
            nb = np.where(fm[..., t], nb_new, nb)
            bb = np.where(fm[..., t], bb_new, bb)
            r_nb[..., t], r_b[..., t] = nb, bb
    return r_nb, r_b


def registers_case(seed, b, k, t, c=9, lens=None, dead_parents=False):
    """Class-major log-probs, ragged frame masks (with a hole in the last
    utterance), parent registers with log-zero stretches (all log-zero for
    the first hypothesis of each utterance with ``dead_parents``), and
    tokens equal to the parent's last on every third hypothesis."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, c) * 3.0
    lp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(F32)
    flat = np.ascontiguousarray(lp.transpose(0, 2, 1).reshape(b * c, t))
    lens = np.asarray(lens if lens is not None else [t] + list(rng.randint(1, t + 1, b - 1)))
    mask = np.arange(t)[None, :] < lens[:, None]
    if t > 3:
        mask[-1, t // 2] = False
    r_nb = (rng.randn(b, k, t) * 5.0 - 40.0).astype(F32)
    r_nb[:, ::2, : max(1, t // 8)] = LZ
    r_b = (rng.randn(b, k, t) * 5.0 - 40.0).astype(F32)
    if dead_parents:
        r_nb[:, 0], r_b[:, 0] = LZ, LZ
    token = rng.randint(1, c, (b, k))
    last = rng.randint(1, c, (b, k))
    last[:, ::3] = token[:, ::3]
    return flat, mask, r_nb, r_b, token, last


def check(got, want, what):
    """Within REL of max(1, |want|) where ``want`` is reached, log-zero on
    both sides where it is not."""
    got, want = np.asarray(got), np.asarray(want)
    reach = want > LZ
    rel = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert rel[reach].max(initial=0.0) <= REL, f"{what}: {rel[reach].max()}"
    assert (got[~reach] <= LZ).all(), what


# (name, batch, beam, T, lengths or None for ragged, dead parents)
CASES = [
    ("T1", 2, 3, 1, [1, 1], False),
    ("T_below_32", 3, 4, 17, None, False),
    ("T_32", 2, 3, 32, [32, 20], False),
    ("T_33", 2, 3, 33, None, False),
    ("T_100_ragged", 3, 4, 100, [100, 37, 1], False),
    ("T_288_dead_parents", 2, 5, 288, None, True),
]


@pytest.mark.parametrize("name,b,k,t,lens,dead", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("empty", [True, False])
def test_scan_matches_plain_and_jax(name, b, k, t, lens, dead, empty):
    flat, mask, r_nb, r_b, token, last = registers_case(len(name) + t, b, k, t, lens=lens,
                                                         dead_parents=dead)
    got = scan_registers(flat, mask, r_nb, r_b, token, last, empty)
    plain = k8.ctc_selected_registers_reference(
        torch.from_numpy(flat), torch.from_numpy(mask), torch.from_numpy(r_nb),
        torch.from_numpy(r_b), torch.from_numpy(token), torch.from_numpy(last), empty)
    want = jax_joint._ctc_selected_registers(
        jnp.asarray(flat), jnp.asarray(mask), jnp.asarray(r_nb), jnp.asarray(r_b),
        jnp.asarray(token, jnp.int32), jnp.asarray(last, jnp.int32), jnp.asarray(empty))
    for reg, g, p, w in zip(("r_nb", "r_b"), got, plain, want):
        check(g, p.numpy(), f"{name} {reg} vs plain")
        check(g, np.asarray(w), f"{name} {reg} vs JAX")
    if dead and not empty:  # a parent with no mass reaches no cell
        assert (got[0][:, 0] <= LZ).all() and (got[1][:, 0] <= LZ).all()


def test_composed_maps_stay_finite_over_long_runs():
    """Log-zero entries of composed maps sum LOG_ZEROs but stay finite (no
    -inf, no NaN) over a 1500-frame utterance of dead parents."""
    flat, mask, r_nb, r_b, token, last = registers_case(5, 1, 2, 1500, lens=[1500],
                                                        dead_parents=True)
    got = scan_registers(flat, mask, r_nb, r_b, token, last, False)
    assert all(np.isfinite(g).all() and (g >= LZ).all() for g in got)
