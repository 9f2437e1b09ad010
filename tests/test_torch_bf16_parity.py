"""The flagship's bf16 serving path, the port against the JAX package, on the
CPU at flagship widths (d_model 512, 8 heads of 64, d_ff 1024, post-LN,
vocabulary 4233, CTC weight 0.3, ``attn_impl="fused"``) and 2+2 layers:
the same float32 weights (JAX's init from ``PRNGKey(0)``, carried across
with ``torch_state_from_flax``) computing in bfloat16 in both packages, on
four utterances of 96, 81, 67 and 90 frames from ``np.random.RandomState``.

Two programs that round to bf16 in different places part by that rounding,
so no fixed tolerance holds them. The yardstick is the JAX package's own
bf16 noise: for each output, d(port bf16, JAX bf16) <= C * d(JAX bf16, JAX
f32), d the max abs difference over the valid rows, and the same of the
mean abs difference with C_MEAN. The max is the reading the card's gate
uses; the mean, steadier, is what sees a slip whose own rounding is of
bf16's size (a log-softmax taken in bf16 triples it). Held so:

- ``encode`` and ``ctc_log_probs`` (frames t < length);
- ``decode_logits``, teacher-forced (positions j < target length);
- 4 cached ``decode_step``s, and 4 ``decode_step_lazy``s over beam 10 with
  an ancestry map that reorders, each package from its own encoder output;
- ``beam_search`` at beam 10, max_len 12, lazy and gather: the n-best
  scores on the rows whose tokens agree.

Besides, the best hypotheses of the port and of JAX are equal, and in each
package the lazy and the gather search give the same n-best (tokens equal,
scores within f32 rounding): in bf16 on the CPU neither package's two
reorders part (the card's parting comes from its summation order).

The JAX side runs its fused attention kernel in Pallas interpret mode; the
port runs its kernels' plain versions, because its tensors lie on the CPU.
The full 6+6 depth is an extra case, marked slow for its minutes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.decode.beam import beam_search as jax_beam_search
from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
from asr_chinese_e2e_tpu.models.transformer import default_config as jax_default_config
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search
from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer

torch.set_num_threads(2)

C = 2.0  # max |port bf16 - JAX bf16| may be at most C times max |JAX bf16 - JAX f32|
C_MEAN = 1.5  # and the mean at most C_MEAN times the mean
VOCAB = 4233
LENGTHS = (96, 81, 67, 90)
BEAM, MAX_LEN, STEPS = 10, 12, 4
DEPTHS = [2, pytest.param(6, marks=pytest.mark.slow)]
OUTPUTS = ("encode", "ctc_log_probs", "decode_logits", "decode_step", "decode_step_lazy",
           "nbest_lazy", "nbest_gather")


def flagship_config(layers: int, dtype: str):
    """The flagship (JAX ``Config``) at ``layers`` + ``layers`` layers."""
    return jax_default_config().build(
        ctc_weight=0.3, attn_impl="fused", num_encoder_layers=layers,
        num_decoder_layers=layers, dtype=dtype,
    )


def _inputs():
    rng = np.random.RandomState(0)
    b, t = len(LENGTHS), max(LENGTHS)
    feats = rng.randn(b, t, 320).astype(np.float32)
    lens = np.asarray(LENGTHS, np.int32)
    ys_lens = np.asarray([9, 4, 12, 7], np.int32)
    ys = rng.randint(0, VOCAB, size=(b, MAX_LEN)).astype(np.int32)
    step_tokens = rng.randint(0, VOCAB, size=(STEPS, b)).astype(np.int32)
    lazy_tokens = rng.randint(0, VOCAB, size=(MAX_LEN, b * BEAM)).astype(np.int32)
    anc = rng.randint(0, BEAM, size=(b, BEAM, MAX_LEN)).astype(np.int32)
    perms = np.stack([rng.permutation(BEAM) for _ in range(MAX_LEN)])
    return dict(feats=feats, lens=lens, ys=ys, ys_lens=ys_lens, step_tokens=step_tokens,
                lazy_tokens=lazy_tokens, anc=anc, perms=perms)


def _ancestry(x):
    """The (B, K, max_len) ancestry maps of the lazy steps: step i sees its
    own column as the identity, then a beam reselection permutes the rows."""
    anc, maps = x["anc"].copy(), []
    for i in range(MAX_LEN):
        anc[:, :, i] = np.arange(BEAM)[None]
        maps.append(anc.copy())
        anc = anc[:, x["perms"][i]]
    return maps


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _gathered(caches, anc, arange):
    """The self-attention caches (B*K, H, L, d) that the gather reorder
    holds where the lazy one holds ``caches`` under the ancestry map
    ``anc`` (B, K, L): row (b, k) at position t is row (b, anc[b, k, t])."""
    b, k, l = anc.shape
    rows, pos = arange(b)[:, None, None], arange(l)
    out = []
    for cache in caches:
        picked = {}
        for name, a in cache.items():
            sel = a.reshape(b, k, *a.shape[1:])[rows, anc, :, pos]  # (B, K, L, H, d)
            picked[name] = sel.swapaxes(2, 3).reshape(a.shape)
        out.append(picked)
    return out


def _run_jax(jm, params, x, modes) -> dict:
    """JAX's outputs, each method jitted as the JAX package serves it."""
    def jit(method, **kw):
        return jax.jit(functools.partial(jm.apply, method=method), **kw)

    feats, lens = jnp.asarray(x["feats"]), jnp.asarray(x["lens"])
    enc, enc_len = jit("encode")(params, feats, lens)
    embed = jit(lambda m, ys: m.decoder._embed_scaled(ys))(params, jnp.asarray(x["ys"]))
    out = {"encode": _f32(enc), "enc_len": np.asarray(enc_len),
           "embed": (str(embed.dtype), _f32(embed)),
           "ctc_log_probs": _f32(jit("ctc_log_probs")(params, enc)),
           "decode_logits": _f32(jit("decode_logits")(
               params, jnp.asarray(x["ys"]), jnp.asarray(x["ys_lens"]), enc, lens))}
    init_state = jit("init_decode_state", static_argnums=(3, 4))
    step, lazy_step = jit("decode_step"), jit("decode_step_lazy")
    state = init_state(params, enc, lens, MAX_LEN, 1)
    steps = []
    for i in range(STEPS):
        lp, state = step(params, jnp.asarray(x["step_tokens"][i]), state, i)
        steps.append(_f32(lp))
    out["decode_step"] = np.stack(steps)
    state = init_state(params, enc, lens, MAX_LEN, BEAM)
    steps, parting = [], 0.0
    for i, anc in enumerate(_ancestry(x)):
        tok, anc = jnp.asarray(x["lazy_tokens"][i]), jnp.asarray(anc)
        gathered = {"carry": {"self": _gathered(state["carry"]["self"], anc, jnp.arange)},
                    "static": state["static"]}
        lp_gathered, _ = step(params, tok, gathered, i)
        lp, state = lazy_step(params, tok, state, i, anc)
        steps.append(_f32(lp))
        parting = max(parting, float(np.abs(steps[-1] - _f32(lp_gathered)).max()))
    out["decode_step_lazy"] = np.stack(steps[:STEPS])
    out["lazy_vs_gathered"] = parting
    for mode in modes:
        res = jax_beam_search(jm, params, enc, enc_len, BEAM, MAX_LEN,
                              lazy=mode == "lazy").materialize()
        out[f"nbest_{mode}"] = (np.asarray(res.tokens), np.asarray(res.scores))
    return out


@torch.no_grad()
def _run_port(tm, x) -> dict:
    feats, lens = torch.from_numpy(x["feats"]), torch.from_numpy(x["lens"])
    enc, enc_len = tm.encode(feats, lens)
    embed = tm.decoder._embed_scaled(torch.from_numpy(x["ys"]).long())
    out = {"encode": _f32(enc), "enc_len": enc_len.numpy(),
           "embed": (str(embed.dtype).replace("torch.", ""), _f32(embed)),
           "ctc_log_probs": _f32(tm.ctc_log_probs(enc)),
           "decode_logits": _f32(tm.decode_logits(
               torch.from_numpy(x["ys"]).long(), torch.from_numpy(x["ys_lens"]), enc, lens))}
    state = tm.init_decode_state(enc, lens, MAX_LEN, 1)
    steps = []
    for i in range(STEPS):
        lp, state = tm.decode_step(torch.from_numpy(x["step_tokens"][i]).long(), state, i)
        steps.append(_f32(lp))
    out["decode_step"] = np.stack(steps)
    state = tm.init_decode_state(enc, lens, MAX_LEN, BEAM)
    steps, parting = [], 0.0
    for i, anc in enumerate(_ancestry(x)):
        tok, anc = torch.from_numpy(x["lazy_tokens"][i]).long(), torch.from_numpy(anc).long()
        gathered = {"carry": {"self": _gathered(state["carry"]["self"], anc, torch.arange)},
                    "static": state["static"]}
        lp_gathered, _ = tm.decode_step(tok, gathered, i)
        lp, state = tm.decode_step_lazy(tok, state, i, anc)
        steps.append(_f32(lp))
        parting = max(parting, float(np.abs(steps[-1] - _f32(lp_gathered)).max()))
    out["decode_step_lazy"] = np.stack(steps[:STEPS])
    out["lazy_vs_gathered"] = parting
    for mode in ("lazy", "gather"):
        res = beam_search(tm, enc, enc_len, BEAM, MAX_LEN, lazy=mode == "lazy").materialize()
        out[f"nbest_{mode}"] = (res.tokens, res.scores)
    return out


@functools.lru_cache(maxsize=None)
def readings(layers: int) -> dict:
    """Every output of JAX f32, JAX bf16 and the port in bf16 at ``layers``
    + ``layers`` layers, as float32 numpy."""
    j32 = JaxModel(flagship_config(layers, "float32"), VOCAB)
    params = jax.jit(j32.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 320)),
                               jnp.asarray([8]), jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]))
    params = jax.tree.map(np.asarray, params)
    jcfg = flagship_config(layers, "bfloat16")
    cfg = Config(**jcfg.to_dict())
    tm = SpeechTransformer(cfg, VOCAB)
    tm.load_state_dict(torch_state_from_flax(params, cfg, VOCAB))
    x = _inputs()
    return {"x": x, "jax32": _run_jax(j32, params, x, ("lazy",)),
            "jax16": _run_jax(JaxModel(jcfg, VOCAB), params, x, ("lazy", "gather")),
            "port": _run_port(tm.eval(), x)}


def _valid(output: str, x: dict) -> np.ndarray:
    """Which leading-index rows of ``output`` are compared."""
    b = len(LENGTHS)
    if output in ("encode", "ctc_log_probs"):
        return np.arange(max(LENGTHS))[None] < x["lens"][:, None]
    if output == "decode_logits":
        return np.arange(MAX_LEN)[None] < x["ys_lens"][:, None]
    if output == "decode_step":
        return np.ones((STEPS, b), bool)
    return np.ones((STEPS, b * BEAM), bool)


def distance(output: str, a: dict, b: dict, x: dict) -> np.ndarray:
    """(max, mean) abs difference of ``output`` between runs ``a`` and
    ``b`` over its valid rows; for an n-best, over the rows (utterance,
    rank) whose tokens agree."""
    if output.startswith("nbest"):
        (ta, sa), (tb, sb) = a[output], b[output]
        agree = (ta == tb).all(-1)
        assert agree.any(), output
        d = np.abs(sa[agree] - sb[agree])
    else:
        rows = _valid(output, x)
        d = np.abs(a[output][rows] - b[output][rows])
    return np.asarray([d.max(), d.mean()], np.float64)


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("output", OUTPUTS)
def test_port_bf16_within_jax_bf16_noise(output, layers):
    r = readings(layers)
    port = distance(output, r["port"], r["jax16"], r["x"])
    noise = _noise(r, output)
    for i, stat in enumerate(("max", "mean")):
        print(f"{layers}+{layers} {output} {stat}: d(port bf16, JAX bf16) {port[i]:.6g}, "
              f"d(JAX bf16, JAX f32) {noise[i]:.6g}, ratio {port[i] / noise[i]:.4f}")
    assert (noise > 0.0).all(), "JAX bf16 equals JAX f32: the yardstick measures nothing"
    assert port[0] <= C * noise[0], ("max", port[0], noise[0])
    assert port[1] <= C_MEAN * noise[1], ("mean", port[1], noise[1])


@pytest.mark.parametrize("layers", DEPTHS)
def test_encoder_lengths_equal(layers):
    r = readings(layers)
    np.testing.assert_array_equal(r["port"]["enc_len"], r["jax16"]["enc_len"])


@pytest.mark.parametrize("layers", DEPTHS)
def test_decoder_input_is_jax_bit_for_bit(layers):
    """The scaled target embedding, the decoder's input: flax's bf16
    embedding times a float32 scalar is float32, and the port's is the
    same bits (a bf16 product here moves the outputs by less than bf16's
    own noise, so the yardstick alone would not see it)."""
    r = readings(layers)
    (got_dtype, got), (want_dtype, want) = r["port"]["embed"], r["jax16"]["embed"]
    assert got_dtype == want_dtype == "float32"
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("mode", ["lazy", "gather"])
def test_best_hypotheses_equal(mode, layers):
    r = readings(layers)
    got, want = r["port"][f"nbest_{mode}"][0], r["jax16"][f"nbest_{mode}"][0]
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    rows = (got == want).all(-1)
    print(f"{layers}+{layers} {mode}: n-best rows equal to JAX bf16 "
          f"{rows.sum()} of {rows.size}")


def _noise(r: dict, output: str) -> np.ndarray:
    """(max, mean) d(JAX bf16, JAX f32) of ``output``: the yardstick."""
    jax_f32 = dict(r["jax32"], nbest_gather=r["jax32"]["nbest_lazy"])
    return distance(output, r["jax16"], jax_f32, r["x"])


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("package", ["jax16", "port"])
def test_lazy_and_gather_nbest_equal(package, layers):
    """The lazy reorder (an ancestry map into unpermuted caches) and the
    gathered caches give the same n-best tokens in each package. Their
    scores part only within the yardstick: the two paths take the
    self-attention scores in GEMMs of different shapes, whose f32 sums can
    differ in the last bit and so round a bf16 weight the other way (on
    the CPU rarely, in both packages; on the card more often)."""
    r = readings(layers)
    (tl, sl), (tg, sg) = r[package]["nbest_lazy"], r[package]["nbest_gather"]
    parting = float(np.abs(sl - sg).max())
    print(f"{layers}+{layers} {package}: lazy vs gather n-best scores, max abs {parting:.6g}")
    np.testing.assert_array_equal(tl, tg)
    assert parting <= C * _noise(r, "nbest_lazy")[0], parting


@pytest.mark.parametrize("layers", DEPTHS)
@pytest.mark.parametrize("package", ["jax16", "port"])
def test_lazy_step_is_the_step_on_gathered_caches(package, layers):
    """Each of 12 lazy steps (the reordering ancestry map) against the
    cached step on the caches that map gathers, within the yardstick of the
    lazy step's log-probs."""
    r = readings(layers)
    parting = r[package]["lazy_vs_gathered"]
    print(f"{layers}+{layers} {package}: lazy step vs step on gathered caches, "
          f"max abs {parting:.6g}")
    assert parting <= C * _noise(r, "decode_step_lazy")[0], parting
