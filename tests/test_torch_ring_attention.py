"""Ring attention (``asr_chinese_e2e_tpu_torch/ops/ring_attention.py``) on
four gloo processes against the JAX package's ``ring_attention`` under
``shard_map`` on the virtual mesh, and against plain attention: outputs and
the gradients of sum(out * g) at seq 4 and seq 2, with every key valid and
with ragged key counts that cross the blocks; the ``attn_impl="ring"``
encoder on a (data 2, seq 2) mesh (T = 9, padded to 10) against the JAX
xla encoder, and two train steps through it against JAX's xla steps.
Tolerance 1e-5 (f32), gradient norms 1e-4 relative as in
``tests/test_torch_train_step.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from asr_chinese_e2e_tpu.parallel.sharding import make_mesh as jax_make_mesh
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.parallel import dryrun
from tests import torch_parallel_cases as cases
from tests.test_ring_attention import reference_attention
from tests.test_torch_parallel import TRAIN, _jax_init, _port_state, assert_moves_match
from tests.test_torch_train_step import ARGS, VOCAB, _batch
from tests.test_transformer import tiny_cfg


def _case(seed, valid):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(2, 16, 2, 8).astype(np.float32) for _ in range(4))
    return {"q": q, "k": k, "v": v, "g": g, "valid": np.asarray(valid, np.int64)}


CASES = {"full": _case(0, [16, 16]), "ragged": _case(1, [11, 5])}
RING_CFG = dict(dropout_rate=0.0, attn_impl="ring", ctc_weight=0.3)


@pytest.fixture(scope="module")
def jax_ring():
    cfg_x = tiny_cfg(dropout_rate=0.0, attn_impl="xla", ctc_weight=0.3)
    batch = _batch(b=4, t=9, seed=3)
    state, train_step = _jax_init(cfg_x, batch)
    init = _port_state(cfg_x, state)
    jm = JaxModel(cfg_x, VOCAB)
    enc, enc_lens = jm.apply(state.params, jnp.asarray(batch["wave"]),
                             jnp.asarray(batch["wave_lengths"]), method="encode")
    args = [jnp.asarray(batch[k]) for k in ARGS]
    losses, norms = [], []
    for _ in range(2):
        state, m = train_step(state, *args, jax.random.key(42, impl="threefry2x32"))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"batch": batch, "init": init, "enc": np.asarray(enc),
            "enc_lens": np.asarray(enc_lens), "losses": losses, "norms": norms,
            "state": _port_state(cfg_x, state)}


@pytest.fixture(scope="module")
def port_ring(jax_ring):
    payload = {
        "cases": CASES, "vocab": VOCAB, "cfg": tiny_cfg(**RING_CFG).to_dict(),
        "state": jax_ring["init"], "feats": jax_ring["batch"]["wave"],
        "feat_lens": jax_ring["batch"]["wave_lengths"], "batch": jax_ring["batch"],
        "train": TRAIN,
    }
    return dryrun.run_ranks(4, cases.ring_cases, payload)


@functools.lru_cache(maxsize=None)
def _jax_ring_grads(name, n_seq):
    """JAX's ring (``tests/test_ring_attention.py::run_ring``'s shard_map,
    jitted) on a case: (out, [dq, dk, dv]) of sum(out * g)."""
    case = CASES[name]
    spec = P(None, "seq")
    ring = shard_map(
        lambda q, k, v, kv: jax_ring_attention(q, k, v, kv, "seq"),
        mesh=jax_make_mesh(data=-1, seq=n_seq), in_specs=(spec, spec, spec, P()),
        out_specs=spec, check_vma=False)

    def loss(q, k, v, valid, g):
        out = ring(q, k, v, valid)
        return (out * g).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(case[x]) for x in ("q", "k", "v", "valid", "g")))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seq", [2, 4])
def test_ring_output_matches_jax_ring(port_ring, seq, name):
    want, _ = _jax_ring_grads(name, seq)
    for rank in port_ring:
        got = rank[seq, name]
        np.testing.assert_allclose(got["out"].numpy(), want[:, got["block"]], atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seq", [2, 4])
def test_ring_gradients_match_jax_ring(port_ring, seq, name):
    """The backward ring (blocks rotating back, dK/dV travelling home with
    theirs) against the transpose of JAX's ppermute scan."""
    _, want = _jax_ring_grads(name, seq)
    for rank in port_ring:
        got = rank[seq, name]
        for g, w in zip(got["grads"], want):
            np.testing.assert_allclose(g.numpy(), w[:, got["block"]], atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("seq", [2, 4])
def test_ring_matches_plain_attention(port_ring, seq, name):
    case = CASES[name]
    want = np.asarray(reference_attention(*(jnp.asarray(case[x]) for x in "qkv"),
                                          jnp.asarray(case["valid"])))
    for rank in port_ring:
        got = rank[seq, name]
        np.testing.assert_allclose(got["out"].numpy(), want[:, got["block"]], atol=1e-5)


def test_ring_encoder_matches_jax_xla(jax_ring, port_ring):
    """attn_impl="ring" on (data 2, seq 2): T = 9 padded to 10, each data
    rank its two rows, against JAX's unsharded xla encoder."""
    for rank in port_ring:
        got = rank["encode"]
        np.testing.assert_array_equal(got["lens"].numpy(), jax_ring["enc_lens"][got["rows"]])
        np.testing.assert_allclose(got["enc"].numpy(), jax_ring["enc"][got["rows"]],
                                   atol=1e-5)


def test_ring_train_steps_match_jax_xla(jax_ring, port_ring):
    """Two train steps through the ring (forward and backward, data 2 x seq
    2) against JAX's xla steps from the same weights, both at the constant
    lr of ``tests/test_torch_parallel.py``: losses, gradient norms, and
    each parameter's move as ``assert_moves_match`` holds it."""
    for rank in port_ring:
        np.testing.assert_allclose(rank["steps"]["losses"], jax_ring["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank["steps"]["norms"], jax_ring["norms"], rtol=1e-4)
        assert_moves_match(rank["steps"]["state"], jax_ring["state"], jax_ring["init"])


def test_ring_without_a_seq_axis_is_the_plain_path():
    """No mesh: ``ring`` is the plain masked path (the model's forward equals
    the xla model's bit for bit)."""
    import torch

    from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer

    feats = np.random.RandomState(4).randn(2, 9, 12).astype(np.float32)
    lens = torch.tensor([9, 6])
    outs = []
    for impl in ("ring", "xla"):
        m = SpeechTransformer(Config(**tiny_cfg(dropout_rate=0.0, attn_impl=impl).to_dict()),
                              VOCAB, torch.Generator().manual_seed(3))
        with torch.no_grad():
            outs.append(m.encode(torch.from_numpy(feats), lens)[0])
    assert torch.equal(outs[0], outs[1])
