"""flax parameter tree -> the port's ``state_dict``.

Takes the JAX package's model parameters as nested dicts of
numpy arrays (a ``{"params": ...}`` variables dict or its inner tree) and
returns float32 torch tensors keyed as the port model's ``state_dict()``.
Layouts:

- ``DenseGeneral`` q/k/v kernels (D, H, dk) and biases (H, dk) ->
  ``nn.Linear`` weight (H*dk, D) and bias (H*dk,);
- the out kernel (H, dk, D) -> weight (D, H*dk);
- ``Dense`` kernels (in, out) -> weight (out, in);
- the tied ``Embed`` table (V, D) -> ``decoder.embed.weight``;
- LayerNorm scale/bias -> weight/bias (the port's LayerNorms use flax's
  epsilon, 1e-6);
- the conformer's depthwise ``Conv`` kernel (k, 1, D) -> ``nn.Conv1d``
  weight (D, 1, k); the conv2d frontend's HWIO kernels (3, 3, in, out) ->
  OIHW (out, in, 3, 3).

The RNN family's and ``ExampleModel``'s trees map too: an
``OptimizedLSTMCell``'s eight kernels become torch's packed (i, f, g, o)
gate rows, the hidden kernels' bias in ``bias_hh`` and zeros in
``bias_ih``; the location conv (k, 1, filters) -> (filters, 1, k).

No jax import: the card's machine can convert arrays saved anywhere.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(p, out: dict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{name}.bias"] = _t(p["bias"])


def _norm(p, out: dict, name: str) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _conv(p, out: dict, name: str) -> None:
    # flax (*spatial, in, out) -> torch (out, in, *spatial)
    kern = np.asarray(p["kernel"])
    out[f"{name}.weight"] = _t(np.moveaxis(kern, (-1, -2), (0, 1)))
    out[f"{name}.bias"] = _t(p["bias"])


def _conformer_block(lp, out: dict, name: str) -> None:
    _mha(lp["attn"], out, f"{name}.attn")
    for ffn in ("ffn1", "ffn2"):
        _dense(lp[ffn]["w1"], out, f"{name}.{ffn}.w1")
        _dense(lp[ffn]["w2"], out, f"{name}.{ffn}.w2")
    conv = lp["conv"]
    _dense(conv["pw1"], out, f"{name}.conv.pw1")
    _conv(conv["dw"], out, f"{name}.conv.dw")
    _norm(conv["norm"], out, f"{name}.conv.norm")
    _dense(conv["pw2"], out, f"{name}.conv.pw2")
    for ln in ("ln_ffn1", "ln_attn", "ln_conv", "ln_ffn2", "ln_final"):
        _norm(lp[ln], out, f"{name}.{ln}")


def _mha(p, out: dict, name: str) -> None:
    for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj")):
        kern = np.asarray(p[src]["kernel"])  # (D, H, dk)
        out[f"{name}.{dst}.weight"] = _t(kern.reshape(kern.shape[0], -1).T)
        out[f"{name}.{dst}.bias"] = _t(np.asarray(p[src]["bias"]).reshape(-1))
    kern = np.asarray(p["out"]["kernel"])  # (H, dk, D)
    out[f"{name}.out_proj.weight"] = _t(kern.reshape(-1, kern.shape[-1]).T)
    out[f"{name}.out_proj.bias"] = _t(p["out"]["bias"])


_GATES = ("i", "f", "g", "o")  # torch's row order of the packed gate weights


def _lstm(p, out: dict, name: str, suffix: str = "") -> None:
    """flax ``OptimizedLSTMCell`` (input kernels ii/if/ig/io, no bias;
    hidden kernels hi/hf/hg/ho, with bias) -> torch's packed gate rows."""
    out[f"{name}.weight_ih{suffix}"] = _t(
        np.concatenate([np.asarray(p[f"i{g}"]["kernel"]).T for g in _GATES]))
    out[f"{name}.weight_hh{suffix}"] = _t(
        np.concatenate([np.asarray(p[f"h{g}"]["kernel"]).T for g in _GATES]))
    bias = np.concatenate([np.asarray(p[f"h{g}"]["bias"]) for g in _GATES])
    out[f"{name}.bias_ih{suffix}"] = _t(np.zeros_like(bias))
    out[f"{name}.bias_hh{suffix}"] = _t(bias)


def _weight(p, out: dict, name: str) -> None:
    """A bias-free ``Dense`` kernel (in, out) -> weight (out, in)."""
    out[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)


def _rnn_state(params, cfg, vocab_size: int) -> dict:
    """BiLSTMCTC / LAS. flax names the encoder's cells in creation order:
    ``OptimizedLSTMCell_{2i}`` is layer i's forward cell, ``_{2i+1}`` its
    backward cell."""
    out: dict = {}
    enc = params["encoder"]
    for i in range(cfg.num_encoder_layers):
        _lstm(enc[f"OptimizedLSTMCell_{2 * i}"], out, f"encoder.fwd.{i}", "_l0")
        _lstm(enc[f"OptimizedLSTMCell_{2 * i + 1}"], out, f"encoder.bwd.{i}", "_l0")
    if "decoder" in params:
        dec = params["decoder"]
        table = np.asarray(dec["embed"]["embedding"])
        if table.shape[0] != vocab_size:
            raise ValueError(f"embedding has {table.shape[0]} rows, vocab {vocab_size}")
        out["decoder.embed.weight"] = _t(table)
        _lstm(dec["cell"], out, "decoder.cell")
        att = dec["attention"]
        _dense(att["query_proj"], out, "decoder.attention.query_proj")
        # flax (k, 1, filters) -> torch (filters, 1, k)
        kern = np.asarray(att["location_conv"]["kernel"])
        out["decoder.attention.location_conv.weight"] = _t(np.moveaxis(kern, (-1, -2), (0, 1)))
        for sub in ("location_proj", "score_proj", "enc_proj_dense"):
            _weight(att[sub], out, f"decoder.attention.{sub}")
        _dense(dec["out_proj"], out, "decoder.out_proj")
    if "ctc_head" in params:
        _dense(params["ctc_head"], out, "ctc_head")
    return out


def torch_state_from_flax(params, cfg, vocab_size: int) -> dict:
    """Map a flax parameter tree of SpeechTransformer, BiLSTMCTC, LAS or
    ExampleModel (told apart by the tree) onto the port's ``state_dict``
    (see the module docstring for the layouts)."""
    if "params" in params:
        params = params["params"]
    if "OptimizedLSTMCell_0" in params.get("encoder", {}):
        return _rnn_state(params, cfg, vocab_size)
    if "Dense_0" in params:  # ExampleModel
        out: dict = {}
        _dense(params["Dense_0"], out, "hidden")
        _dense(params["Dense_1"], out, "out")
        return out
    out: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    if "frontend_mod" in enc:  # conv2d frontend
        front = enc["frontend_mod"]
        _conv(front["conv0"], out, "encoder.frontend_mod.conv0")
        _conv(front["conv1"], out, "encoder.frontend_mod.conv1")
        _dense(front["proj"], out, "encoder.frontend_mod.proj")
    else:
        _dense(enc["input_proj"], out, "encoder.input_proj")
        _norm(enc["input_norm"], out, "encoder.input_norm")
    conformer = cfg.get("encoder_type", "transformer") == "conformer"
    for i in range(cfg.num_encoder_layers):
        lp, name = enc[f"layer{i}"], f"encoder.layers.{i}"
        if conformer:
            _conformer_block(lp, out, name)
            continue
        _mha(lp["attn"], out, f"{name}.attn")
        _dense(lp["ffn"]["w1"], out, f"{name}.ffn.w1")
        _dense(lp["ffn"]["w2"], out, f"{name}.ffn.w2")
        for sub in ("sub1", "sub2"):
            _norm(lp[sub]["LayerNorm_0"], out, f"{name}.{sub}.norm")
    if "final_norm" in enc:
        _norm(enc["final_norm"], out, "encoder.final_norm")
    table = np.asarray(dec["embed"]["embedding"])
    if table.shape[0] != vocab_size:
        raise ValueError(f"embedding has {table.shape[0]} rows, vocab {vocab_size}")
    out["decoder.embed.weight"] = _t(table)
    for i in range(cfg.num_decoder_layers):
        lp, name = dec[f"layer{i}"], f"decoder.layers.{i}"
        _mha(lp["self_attn"], out, f"{name}.self_attn")
        _mha(lp["cross_attn"], out, f"{name}.cross_attn")
        _dense(lp["ffn"]["w1"], out, f"{name}.ffn.w1")
        _dense(lp["ffn"]["w2"], out, f"{name}.ffn.w2")
        for sub in ("sub1", "sub2", "sub3"):
            _norm(lp[sub]["LayerNorm_0"], out, f"{name}.{sub}.norm")
    if "final_norm" in dec:
        _norm(dec["final_norm"], out, "decoder.final_norm")
    if "ctc_head" in params:
        _dense(params["ctc_head"], out, "ctc_head")
    return out
