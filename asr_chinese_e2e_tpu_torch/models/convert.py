"""flax parameter tree -> the port's ``state_dict``.

Takes the JAX package's SpeechTransformer parameters as nested dicts of
numpy arrays (a ``{"params": ...}`` variables dict or its inner tree) and
returns float32 torch tensors keyed as ``SpeechTransformer.state_dict()``.
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


def torch_state_from_flax(params, cfg, vocab_size: int) -> dict:
    """Map a flax SpeechTransformer parameter tree onto the port's
    ``state_dict`` (see the module docstring for the layouts)."""
    if "params" in params:
        params = params["params"]
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
