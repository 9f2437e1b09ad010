"""The port's parallelism (``asr_chinese_e2e_tpu_torch/parallel/``) against
the JAX package's on the CPU: the mesh layout and the tensor-parallel
rules, then real gloo process groups (spawned once per group of cases,
``parallel/dryrun.py::run_ranks``) against JAX's virtual 8-device mesh:

- data-parallel steps (data 2) at hash dropout 0.1 through the fused
  attention against JAX's steps on ``make_mesh(data=2)``;
- tensor parallelism (model 2): three train steps against JAX's
  replicated run, the split parameters and their Adam moments;
- the sharded attention with its seed fold against JAX's
  ``fused_attention_sharded_general``, and its unsharded fallback; the
  square entry point ``fused_attention_sharded`` against JAX's and against
  the general call with both lengths;
- ``dryrun_multichip(4)`` and ``(8)``.

Tolerances: 1e-5 in f32 (losses relative, weights and outputs absolute,
each parameter's move over the steps relative to that move), gradient
norms 1e-4 relative as in ``tests/test_torch_train_step.py``. The train
steps run at a constant lr of 1e-3 on both sides, so that they move the
weights far beyond those bounds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from asr_chinese_e2e_tpu.data.features import FeatureConfig as JaxFeatureConfig
from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.ops.fused_attention import (
    fused_attention_general as jax_fused_attention_general,
    fused_attention_sharded as jax_fused_attention_sharded,
    fused_attention_sharded_general as jax_fused_attention_sharded_general,
)
from asr_chinese_e2e_tpu.parallel.context import active_mesh as jax_active_mesh
from asr_chinese_e2e_tpu.parallel.sharding import (
    batch_sharding,
    make_mesh as jax_make_mesh,
    param_shardings as jax_param_shardings,
    param_spec as jax_param_spec,
    replicated,
)
from asr_chinese_e2e_tpu.train.optimizer import default_train_config as jax_train_config
from asr_chinese_e2e_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from asr_chinese_e2e_tpu.train.train_step import make_step_fns as jax_make_step_fns
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
from asr_chinese_e2e_tpu_torch.ops.fused_attention import seed_at_cell
from asr_chinese_e2e_tpu_torch.parallel import dryrun, sharding
from asr_chinese_e2e_tpu_torch.parallel.sharding import MODEL_AXIS, mesh_shape, param_spec
from tests import torch_parallel_cases as cases
from tests.test_torch_train_step import ARGS, VOCAB, _batch
from tests.test_transformer import tiny_cfg

SEED = 12345  # every dropout seed of the data-parallel step, both sides

# -- the mesh and the rules -----------------------------------------------------


@pytest.mark.parametrize("n,kw,want", [
    (8, dict(model=2), (4, 2, 1)),
    (8, dict(), (8, 1, 1)),
    (8, dict(data=2, model=2, seq=2), (2, 2, 2)),
    (4, dict(seq=2), (2, 1, 2)),
])
def test_mesh_shape_absorbs_the_data_axis_as_jax(n, kw, want):
    got = mesh_shape(n, **kw)
    assert (got["data"], got["model"], got["seq"]) == want
    jax_mesh = jax_make_mesh(**kw, devices=jax.devices()[:n])
    assert (jax_mesh.shape["data"], jax_mesh.shape["model"], jax_mesh.shape["seq"]) == want


def test_mesh_shape_refuses_what_does_not_divide():
    with pytest.raises(AssertionError):
        mesh_shape(8, model=3)
    with pytest.raises(AssertionError):
        mesh_shape(4, data=4, model=2)


def test_single_process_mesh_needs_no_group():
    mesh = sharding.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1, "seq": 1}
    assert mesh.group("data") is None and mesh.index("model") == 0
    with pytest.raises(ValueError, match="ranks"):
        sharding.make_mesh(data=2)


# (port name, port shape, head_dim, flax path, flax shape): the cases of
# tests/test_sharding.py::test_param_spec_rules in both namings
RULES = [
    ("encoder.layers.0.attn.q_proj.weight", (64, 64), 16,
     "encoder/layer0/attn/q/kernel", (64, 4, 16)),
    ("decoder.layers.1.ffn.w1.weight", (128, 64), None,
     "decoder/layer1/ffn/w1/kernel", (64, 128)),
    ("decoder.embed.weight", (32, 64), None, "decoder/embed/embedding", (32, 64)),
    ("encoder.layers.0.attn.q_proj.weight", (48, 64), 16,
     "encoder/layer0/attn/q/kernel", (64, 3, 16)),  # 3 heads: replicated
    ("encoder.input_norm.weight", (64,), None, "encoder/input_norm/scale", (64,)),
    ("decoder.layers.0.cross_attn.out_proj.weight", (64, 64), 16,
     "decoder/layer0/cross_attn/out/kernel", (4, 16, 64)),
]


@pytest.mark.parametrize("name,shape,head_dim,path,jshape", RULES)
@pytest.mark.parametrize("tp", [1, 2])
def test_param_spec_rules_split_what_jax_splits(name, shape, head_dim, path, jshape, tp):
    got = param_spec(name, shape, tp, head_dim)
    want = jax_param_spec(path, jshape, tp)
    assert (got != ()) == (want != P()), (got, want)
    if got:  # the same dimension of the same tensor (flax kernels are transposed)
        assert shape[got.index(MODEL_AXIS)] == jshape[list(want).index(MODEL_AXIS)] \
            * (head_dim if head_dim and len(jshape) == 3 else 1)


def test_param_shardings_split_the_parameters_jax_splits():
    """On the tiny transformer: as many parameters split over ``model`` as
    JAX's rules split (q/k/v kernels and biases and the out kernel of each
    attention, w1's kernel and bias and w2's kernel of each FFN, the
    embedding), all of those kinds."""
    cfg = tiny_cfg(dropout_rate=0.0)
    jm = JaxModel(cfg, VOCAB)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 12)), jnp.asarray([8]),
                     jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]))
    specs = jax_param_shardings(jax_make_mesh(data=-1, model=2), params)
    want = sum(s.spec != P() for s in jax.tree_util.tree_leaves(specs))
    model = SpeechTransformer(Config(**cfg.to_dict()), VOCAB)
    got = {k for k, v in sharding.param_shardings(
        model, sharding.Mesh({"data": 4, "model": 2, "seq": 1})).items() if v}
    assert len(got) == want == 7 * 6 + 3 * 4 + 1
    assert all(any(s in k for s in ("_proj.", "ffn.w1", "ffn.w2", "embed")) for k in got)


def test_conformer_pointwise_convs_stay_whole():
    """JAX's ``.*w1/kernel`` also matches the conformer's ``conv/pw1`` (and
    ``w2`` its ``pw2``), which GSPMD then reshards around the GLU. The port
    splits only what its layers sum or gather over the axis: the conv
    module's pointwise layers stay whole."""
    assert jax_param_spec("encoder/layer0/conv/pw1/kernel", (64, 128), 2) != P()
    assert param_spec("encoder.layers.0.conv.pw1.weight", (128, 64), 2) == ()
    assert param_spec("encoder.layers.0.conv.pw2.weight", (64, 64), 2) == ()
    assert param_spec("encoder.layers.0.ffn1.w1.weight", (128, 64), 2) == (MODEL_AXIS, None)


def test_seed_at_cell_moves_the_keep_hash_by_whole_cells():
    """A call on rows [r, r + B) with ``seed_at_cell(seed, r H)`` draws the
    whole batch's keep mask on those rows."""
    from asr_chinese_e2e_tpu_torch.ops.fused_attention import keep_mask_reference

    whole = keep_mask_reference(77, 6, 3, 5, 7, 0.3)
    part = keep_mask_reference(seed_at_cell(77, 4 * 3), 2, 3, 5, 7, 0.3)
    assert torch.equal(part, whole[4:6])


# -- two ranks: data and tensor parallel steps ----------------------------------


def _jax_init(cfg, batch):
    tcfg = jax_train_config().combine(cfg).build(rng_impl="threefry2x32", **TRAIN)
    jm = JaxModel(cfg, VOCAB)
    init_fn, train_step, _ = jax_make_step_fns(
        jm, jax_make_optimizer(tcfg, cfg.d_model), JaxFeatureConfig(), tcfg,
        raw_features=True)
    return init_fn(jax.random.PRNGKey(42), batch), train_step


def _port_state(cfg, state):
    return torch_state_from_flax(jax.tree.map(np.asarray, state.params),
                                 Config(**cfg.to_dict()), VOCAB)


DP_CFG = dict(dropout_rate=0.1, dropout_impl="hash", attn_impl="fused",
              decoder_attn_impl="fused", ctc_weight=0.3)
TP_CFG = dict(dropout_rate=0.0, ctc_weight=0.3)
# both sides: a constant lr, so that the steps move each weight by about
# 1e-3 a step, far above the bounds (Noam's first steps at this width would
# move it by ~1e-6)
TRAIN = dict(lr_schedule="constant", lr=1e-3)
STEPS = 3
MOVE_RTOL = 1e-5  # each parameter's move over the steps, |diff| / |move|
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def jax_train(monkeypatch_module):
    dp_cfg, tp_cfg = tiny_cfg(**DP_CFG), tiny_cfg(**TP_CFG)
    dp_batch, tp_batch = _batch(b=4, t=13), _batch(b=4, t=11, seed=1)
    out = {"dp_batch": dp_batch, "tp_batch": tp_batch}
    state, train_step = _jax_init(dp_cfg, dp_batch)
    out["dp_init"] = _port_state(dp_cfg, state)
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    state = jax.device_put(state, replicated(mesh))
    args = [jax.device_put(dp_batch[k], batch_sharding(mesh)) for k in ARGS]
    monkeypatch_module.setattr(jax.random, "randint",
                               lambda *a, **k: jnp.asarray(SEED, jnp.int32))
    losses, norms = [], []
    with jax_active_mesh(mesh):
        for _ in range(STEPS):
            state, m = train_step(state, *args, jax.random.key(42, impl="threefry2x32"))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    monkeypatch_module.undo()
    out["dp"] = {"losses": losses, "norms": norms, "state": _port_state(dp_cfg, state)}
    state, train_step = _jax_init(tp_cfg, tp_batch)
    out["tp_init"] = _port_state(tp_cfg, state)
    args = [jnp.asarray(tp_batch[k]) for k in ARGS]
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = train_step(state, *args, jax.random.key(42, impl="threefry2x32"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["tp"] = {"losses": losses, "norms": norms, "state": _port_state(tp_cfg, state)}
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_train(jax_train):
    payload = {
        "vocab": VOCAB, "seed": SEED,
        "dp_cfg": tiny_cfg(**DP_CFG).to_dict(), "dp_state": jax_train["dp_init"],
        "dp_batch": jax_train["dp_batch"],
        "tp_cfg": tiny_cfg(**TP_CFG).to_dict(), "tp_state": jax_train["tp_init"],
        "tp_batch": jax_train["tp_batch"], "train": TRAIN, "steps": STEPS,
    }
    return dryrun.run_ranks(2, cases.train_cases, payload)


def assert_moves_match(got: dict, want: dict, start: dict) -> None:
    """Every parameter's move over the steps (after - start) within
    ``MOVE_RTOL`` of the reference's, |diff| <= MOVE_RTOL |move| plus the
    f32 rounding of the weights it moved (eps |w|: a LayerNorm scale near
    1 moved by 3e-3 keeps one ulp of 1, 4e-5 of its move), and the weights
    within 1e-5 absolute. The key projections' biases are left out: their
    gradient is zero in exact arithmetic (a softmax does not see a shift of
    its row), so Adam moves them by +-lr on the sign of a rounding."""
    assert got.keys() == want.keys()
    for name, p in got.items():
        if name.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        move = float((want[name] - start[name]).norm())
        diff = float((p - want[name]).norm())
        floor = F32_EPS * float(want[name].norm())
        assert diff <= MOVE_RTOL * move + floor, (
            f"{name}: move |diff| {diff:.3e} > {MOVE_RTOL:.0e} x |move| {move:.3e} + "
            f"eps |w| {floor:.3e}")


def test_dp_step_matches_jax_data_mesh(jax_train, port_train):
    """Two ranks of two rows each at hash dropout 0.1 (the fused attention
    folding its seed per rank, the activations' hash offset by the rank's
    first element) against JAX's steps on make_mesh(data=2): the losses and
    gradient norms, and the same on both ranks."""
    want = jax_train["dp"]
    for rank in port_train:
        np.testing.assert_allclose(rank["dp"]["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["dp"]["norms"], want["norms"], rtol=1e-4)


def test_dp_step_weights_match_jax_on_every_rank(jax_train, port_train):
    for rank in port_train:
        assert_moves_match(rank["dp"]["state"], jax_train["dp"]["state"], jax_train["dp_init"])


def test_tp_steps_match_jax_replicated_run(jax_train, port_train):
    """Model 2 (heads, d_ff and the vocabulary split; the out and w2 sums
    and the logits' gather over the axis): three steps' losses and
    gradient norms against JAX's unsharded run."""
    want = jax_train["tp"]
    for rank in port_train:
        np.testing.assert_allclose(rank["tp"]["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["tp"]["norms"], want["norms"], rtol=1e-4)


def test_tp_weights_gathered_match_jax(jax_train, port_train):
    assert_moves_match(port_train[0]["tp"]["state"], jax_train["tp"]["state"],
                       jax_train["tp_init"])


def test_tp_splits_parameters_and_adam_moments_follow(port_train):
    """Every split parameter holds half its whole tensor on each rank, and
    Adam's moments have its chunk's shape (the JAX package's
    ``state_shardings`` property, with no code: torch's moments are made
    per parameter)."""
    tp = port_train[0]["tp"]
    assert tp["split"], "no parameter split"
    for name, spec in tp["split"].items():
        dim = spec.index(MODEL_AXIS)
        whole, local = tp["whole"][name], tp["local"][name]
        assert local[dim] * 2 == whole[dim]
        assert tp["moments"][name] == {"exp_avg": local, "exp_avg_sq": local}
    unsplit = [k for k in tp["whole"] if k not in tp["split"]]
    assert all(tp["whole"][k] == tp["local"][k] for k in unsplit)


# -- four ranks: the sharded attention --------------------------------------------


def _attention_case(seed, b, h, rate, heads_split):
    rng = np.random.RandomState(seed)
    t, d = 16, 8
    q, k, v, g = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    return {"q": q, "k": k, "v": v, "g": g,
            "lengths": rng.randint(4, t + 1, size=(b,)).astype(np.int32),
            "seed": 1234, "scale": 0.5, "rate": rate, "heads_split": heads_split}


ATTENTION_CASES = {
    "no-dropout": _attention_case(0, 8, 4, 0.0, True),
    "dropout": _attention_case(1, 8, 4, 0.1, True),
    "dropout-heads-not-split": _attention_case(2, 8, 3, 0.1, False),
}


@pytest.fixture(scope="module")
def port_attention():
    return dryrun.run_ranks(4, cases.sharded_attention_cases, ATTENTION_CASES)


@functools.lru_cache(maxsize=None)
def _jax_attention(name, square=False):
    case = ATTENTION_CASES[name]
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    lens = jnp.asarray(case["lengths"])
    seed = jnp.asarray(case["seed"], jnp.int32)

    def loss(q, k, v):
        if square:
            out = jax_fused_attention_sharded(
                mesh, q, k, v, lens, seed, case["scale"], case["rate"])
        else:
            out = jax_fused_attention_sharded_general(
                mesh, q, k, v, lens, lens, seed, case["scale"], case["rate"], False)
        return (out * case["g"]).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[x]) for x in "qkv"))
    return np.asarray(out), [np.asarray(gr) for gr in grads]


@pytest.mark.parametrize("name", list(ATTENTION_CASES))
def test_sharded_attention_matches_jax(port_attention, name):
    """Each rank's rows and heads against JAX's shard_mapped call on a (data
    2, model 2) mesh: outputs and gradients within 1e-5. With dropout the
    seed is folded per rank (seed + data_index * 2 + model_index); with 3
    heads (no split) JAX runs unsharded, and the port moves the seed to the
    rank's first cell (``seed_at_cell``) to draw the same mask."""
    want_out, want_grads = _jax_attention(name)
    for rank in port_attention:
        got = rank[name]
        sl = (got["rows"], got["cols"])
        np.testing.assert_allclose(got["out"].numpy(), want_out[sl], atol=1e-5)
        for g, w in zip(got["grads"], want_grads):
            np.testing.assert_allclose(g.numpy(), w[sl], atol=1e-5)


@pytest.mark.parametrize("name", list(ATTENTION_CASES))
def test_square_sharded_attention_is_the_general_call(port_attention, name):
    """``fused_attention_sharded`` is ``fused_attention_sharded_general``
    with the lengths as both masks, non-causal: the same outputs and
    gradients bit for bit on every rank, and JAX's square call's within
    1e-5."""
    want_out, want_grads = _jax_attention(name, square=True)
    for rank in port_attention:
        got, square = rank[name], rank[name]["square"]
        sl = (got["rows"], got["cols"])
        assert torch.equal(square["out"], got["out"])
        for g, s in zip(got["grads"], square["grads"]):
            assert torch.equal(s, g)
        np.testing.assert_allclose(square["out"].numpy(), want_out[sl], atol=1e-5)
        for s, w in zip(square["grads"], want_grads):
            np.testing.assert_allclose(s.numpy(), w[sl], atol=1e-5)


def test_unsharded_fallback_is_the_plain_call():
    """Where JAX falls back (3 heads over model 2), its sharded call is its
    plain call: the port's fallback draws that."""
    case = ATTENTION_CASES["dropout-heads-not-split"]
    lens = jnp.asarray(case["lengths"])
    seed = jnp.asarray(case["seed"], jnp.int32)
    args = [jnp.asarray(case[x]) for x in "qkv"]
    plain = jax_fused_attention_general(*args, lens, lens, seed, case["scale"], case["rate"],
                                        False)
    want_out, _ = _jax_attention("dropout-heads-not-split")
    np.testing.assert_allclose(np.asarray(plain), want_out, atol=1e-6)


# -- the dry run -------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip(n):
    """One training step per mesh of n CPU ranks: DP x TP (model 2), and at
    n = 8 DP x TP x SP with ring attention over seq 2; finite losses."""
    results = dryrun.dryrun_multichip(n)
    want = [{"data": n // 2, "model": 2, "seq": 1}]
    if n == 8:
        want.append({"data": 2, "model": 2, "seq": 2})
    assert [r["mesh"] for r in results] == want
    assert all(np.isfinite(r["loss"]) and r["split"] for r in results)
