"""The port's conformer family against the JAX package's, on the CPU, f32,
with flax-converted weights and numpy-seeded inputs:

- ``ConvModule`` against the flax module (SAME and causal padding, k = 15
  and the even k = 4, with lengths) at 1e-5, and its pad invariance
  (``tests/test_conformer.py``'s case) at 1e-6;
- ``ConvSubsampler`` at even and odd T x F at 1e-5 (flax pads stride-2
  ``SAME`` asymmetrically), and its lengths;
- the whole conformer ``SpeechTransformer`` (``attn_impl`` xla and fused,
  linear and conv2d frontends): logits, CTC logits and the valid encoder
  rows at 1e-4, and the subsampled lengths exactly;
- ``remat``: on and off give identical losses and gradients at dropout 0.1
  (``dropout_impl`` rng and hash), for both encoder families;
- bf16 computation from f32 master weights in the conv layers;
- the ``Conformer`` registry entry builds the JAX entry's parameters.

The JAX side runs the fused attention kernel in Pallas interpret mode on
the CPU, as its own tests do; the port runs the kernel's plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.core.registry import get_model as jax_get_model
from asr_chinese_e2e_tpu.models.layers import ConvModule as JaxConvModule
from asr_chinese_e2e_tpu.models.layers import ConvSubsampler as JaxConvSubsampler
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.core.registry import get_model
from asr_chinese_e2e_tpu_torch.losses import model_loss
from asr_chinese_e2e_tpu_torch.models.convert import (
    _conv,
    _dense,
    _norm,
    torch_state_from_flax,
)
from asr_chinese_e2e_tpu_torch.models.layers import ConvModule, ConvSubsampler
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
from tests.test_torch_model import VOCAB, model_pair, tiny_config

torch.set_num_threads(2)


def _conv_module_pair(d, k, causal, x, lengths):
    """(flax module, its params, the port's module with converted weights)."""
    jmod = JaxConvModule(d_model=d, kernel_size=k, causal=causal)
    params = jmod.init(jax.random.PRNGKey(k), jnp.asarray(x), jnp.asarray(lengths))
    p = jax.tree.map(np.asarray, params)["params"]
    state = {}
    _dense(p["pw1"], state, "pw1")
    _conv(p["dw"], state, "dw")
    _norm(p["norm"], state, "norm")
    _dense(p["pw2"], state, "pw2")
    tmod = ConvModule(d, k, causal=causal)
    tmod.load_state_dict(state)
    return jmod, params, tmod.eval()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("k", [15, 4])
def test_conv_module_matches_flax(k, causal):
    rng = np.random.RandomState(k + causal)
    x = rng.randn(3, 19, 16).astype(np.float32)
    lengths = np.asarray([19, 11, 4], np.int32)
    jmod, params, tmod = _conv_module_pair(16, k, causal, x, lengths)
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_conv_module_pad_invariance(causal):
    """Valid frames do not depend on how much padding follows: the module
    zeroes padded frames before the depthwise conv."""
    x = np.random.RandomState(0).randn(1, 20, 16).astype(np.float32)
    lengths = np.asarray([14], np.int32)
    _, _, tmod = _conv_module_pair(16, 5, causal, x, lengths)
    with torch.no_grad():
        short = tmod(torch.from_numpy(x[:, :16]), torch.from_numpy(lengths))
        full = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(short[:, :14].numpy(), full[:, :14].numpy(), atol=1e-6)


@pytest.mark.parametrize("t,f", [(16, 24), (17, 24), (16, 23), (17, 23)])
def test_conv_subsampler_matches_flax(t, f):
    rng = np.random.RandomState(t * f)
    x = rng.randn(2, t, f).astype(np.float32)
    lengths = np.asarray([t, t - 6], np.int32)
    jmod = JaxConvSubsampler(d_model=32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lengths))
    want, want_len = jmod.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    p = jax.tree.map(np.asarray, params)["params"]
    state = {}
    _conv(p["conv0"], state, "conv0")
    _conv(p["conv1"], state, "conv1")
    _dense(p["proj"], state, "proj")
    tmod = ConvSubsampler(32, f)
    tmod.load_state_dict(state)
    with torch.no_grad():
        got, got_len = tmod(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (2, ((t + 1) // 2 + 1) // 2, 32)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_conv_subsampler_lengths():
    """``tests/test_transformer.py::test_conv2d_frontend``'s case: 9 frames
    with lengths [9, 6] give 3 frames and lengths [3, 2]."""
    tmod = ConvSubsampler(32, 12)
    x = torch.randn(2, 9, 12, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, lengths = tmod(x, torch.tensor([9, 6], dtype=torch.int32))
    assert y.shape == (2, 3, 32)
    assert lengths.tolist() == [3, 2]


def test_conv_layers_compute_in_bf16_from_f32_weights():
    """Master weights stay f32 and are cast at use: a bf16 layer on f32
    weights keeps its activations in bf16, and a model cast to bf16 for
    serving computes the same."""
    x = torch.randn(2, 11, 16, generator=torch.Generator().manual_seed(0))
    lengths = torch.tensor([11, 6])
    conv = ConvModule(16, 5, dtype=torch.bfloat16)
    sub = ConvSubsampler(16, 16, dtype=torch.bfloat16)
    with torch.no_grad():
        y = conv(x.bfloat16(), lengths)
        z, _ = sub(x, lengths)
        assert conv.dw.weight.dtype == sub.conv1.weight.dtype == torch.float32
        assert y.dtype == z.dtype == torch.bfloat16
        assert torch.equal(conv.to(torch.bfloat16)(x.bfloat16(), lengths), y)
        assert torch.equal(sub.to(torch.bfloat16)(x, lengths)[0], z)


FORWARD_CONFIGS = {
    "xla-linear": dict(attn_impl="xla"),
    "fused-linear": dict(attn_impl="fused"),
    "xla-conv2d": dict(attn_impl="xla", frontend="conv2d"),
    "fused-conv2d": dict(attn_impl="fused", frontend="conv2d"),
}


def conformer_config(**overrides):
    """A 2+2-layer, 32-wide conformer config (JAX ``Config``)."""
    base = dict(encoder_type="conformer", norm_type="pre", conv_kernel_size=5)
    base.update(overrides)
    return tiny_config(**base)


@pytest.mark.parametrize("name", list(FORWARD_CONFIGS))
def test_conformer_forward_matches_jax(name):
    jm, params, tm = model_pair(conformer_config(**FORWARD_CONFIGS[name]))
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 15, 24).astype(np.float32)
    lens = np.asarray([15, 9], np.int32)
    labels = rng.randint(4, VOCAB, size=(2, 5)).astype(np.int32)
    label_lens = np.asarray([5, 3], np.int32)
    args = (feats, lens, labels, label_lens)
    want = jm.apply(params, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in args))
    enc_len = np.asarray(want["enc_lengths"])
    np.testing.assert_array_equal(got["enc_lengths"].numpy(), enc_len)
    if FORWARD_CONFIGS[name].get("frontend") == "conv2d":
        assert enc_len.tolist() == [4, 3] and got["enc_out"].shape[1] == 4
    for key in ("logits", "ctc_logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                   rtol=0, err_msg=key)
    for b, n in enumerate(enc_len):
        np.testing.assert_allclose(got["enc_out"][b, :n].numpy(),
                                   np.asarray(want["enc_out"])[b, :n], atol=1e-4, rtol=0)


def _loss_and_grads(cfg, batch, seed=5):
    """One teacher-forced forward with dropout drawn from a generator
    seeded ``seed``, the hybrid loss and its gradients; also the state the
    forward left the generator in."""
    tm = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0))
    tm.train()
    rng = torch.Generator().manual_seed(seed)
    out = tm(*batch[:4], rng=rng)
    loss, _ = model_loss(out, batch[2], batch[3], 0.3, 0.1, "pallas")
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in tm.named_parameters()}, rng.get_state()


@pytest.mark.parametrize("impl", ["rng", "hash"])
@pytest.mark.parametrize("encoder_type", ["conformer", "transformer"])
def test_remat_gives_identical_loss_and_gradients(encoder_type, impl):
    """The recomputation replays the layer's dropout draws exactly."""
    base = dict(encoder_type=encoder_type, norm_type="pre", conv_kernel_size=5,
                dropout_rate=0.1, dropout_impl=impl, attn_impl="fused")
    rng = np.random.RandomState(3)
    batch = (
        torch.from_numpy(rng.randn(2, 13, 24).astype(np.float32)),
        torch.tensor([13, 8], dtype=torch.int32),
        torch.from_numpy(rng.randint(4, VOCAB, size=(2, 4)).astype(np.int32)),
        torch.tensor([4, 2], dtype=torch.int32),
    )
    runs = {}
    for remat in (False, True):
        cfg = Config(**tiny_config(**base, remat=remat).to_dict())
        runs[remat] = _loss_and_grads(cfg, batch)
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert torch.equal(l0, l1) and torch.isfinite(l0)
    assert torch.equal(s0, s1)  # later draws (the CTC head's, the next step's) agree
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # dropout drew: a different seed changes the loss
    cfg = Config(**tiny_config(**base, remat=True).to_dict())
    assert not torch.equal(_loss_and_grads(cfg, batch, seed=6)[0], l1)


def test_conformer_registry_entry_builds_the_jax_parameters():
    """``Conformer`` resolves to a model whose parameters are exactly the
    JAX entry's (names and shapes through the converter), at the entry's
    defaults with narrow widths."""
    small = dict(d_model=32, num_heads=4, head_dim=8, d_ff=64, num_encoder_layers=2,
                 num_decoder_layers=1, ctc_weight=0.3, input_dim=24)
    jcls, jdefault = jax_get_model("Conformer")
    jcfg = jdefault().build(**small)
    jm = jcls(jcfg, VOCAB)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 24)), jnp.asarray([8]),
                     jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]))
    cls, default = get_model("Conformer")
    cfg = default().build(**small)
    assert cfg.encoder_type == "conformer" and cfg.conv_kernel_size == 15
    tm = cls(cfg, VOCAB)
    assert isinstance(tm, SpeechTransformer)
    tm.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params), cfg, VOCAB))
    assert tm.encoder.final_norm is None  # a conformer block ends in its own norm
    with torch.no_grad():
        enc, enc_len = tm.encode(torch.zeros(1, 8, 24), torch.tensor([8]))
    assert enc.shape == (1, 8, 32) and torch.isfinite(enc).all()
