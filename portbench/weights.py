"""The benchmark's weights: made from the seed on the device, in a few large
calls, under the parameter names of the port's ``SpeechTransformer`` state
dict, and handed alike to the program and to the plain reference.

The distributions follow the port's initialisers (lecun-normal dense
kernels and zero biases, embeddings normal with std 1/sqrt(d), unit
LayerNorm scales), so the activations have the sizes of an untrained
model of these widths. Weights are float32 masters.
"""

from __future__ import annotations

import math

import torch


def leaf_specs(model: dict, vocab_size: int) -> list:
    """[(name, shape, std)] of every parameter, in the port's state-dict
    order; std 0 is a zero bias, None a unit LayerNorm scale."""
    d, ff = model["d_model"], model["d_ff"]
    inner = model["num_heads"] * model["head_dim"]
    pre = model.get("norm_type", "post") == "pre"
    specs = []

    def dense(name, n_in, n_out):
        specs.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5))
        specs.append((f"{name}.bias", (n_out,), 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), None))
        specs.append((f"{name}.bias", (d,), 0.0))

    def attention(name):
        for proj in ("q_proj", "k_proj", "v_proj"):
            dense(f"{name}.{proj}", d, inner)
        dense(f"{name}.out_proj", inner, d)

    dense("encoder.input_proj", model["input_dim"], d)
    norm("encoder.input_norm")
    for i in range(model["num_encoder_layers"]):
        p = f"encoder.layers.{i}"
        attention(f"{p}.attn")
        dense(f"{p}.ffn.w1", d, ff)
        dense(f"{p}.ffn.w2", ff, d)
        norm(f"{p}.sub1.norm")
        norm(f"{p}.sub2.norm")
    if pre:
        norm("encoder.final_norm")
    specs.append(("decoder.embed.weight", (vocab_size, d), d ** -0.5))
    for i in range(model["num_decoder_layers"]):
        p = f"decoder.layers.{i}"
        attention(f"{p}.self_attn")
        attention(f"{p}.cross_attn")
        dense(f"{p}.ffn.w1", d, ff)
        dense(f"{p}.ffn.w2", ff, d)
        for j in (1, 2, 3):
            norm(f"{p}.sub{j}.norm")
    if pre:
        norm("decoder.final_norm")
    if float(model.get("ctc_weight", 0.0)) > 0.0:
        dense("ctc_head", d, vocab_size)
    return specs


def make_weights(model: dict, vocab_size: int, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``}: one normal draw for all the
    random leaves from a generator on ``device`` seeded with ``seed``, then
    each leaf a scaled view of it; zeros and ones for the rest."""
    specs = leaf_specs(model, vocab_size)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n_random = sum(math.prod(shape) for _, shape, std in specs if std)
    flat = torch.randn(n_random, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, device=device)
        elif std == 0.0:
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[offset : offset + n].view(shape).mul_(std)
            offset += n
    return out

