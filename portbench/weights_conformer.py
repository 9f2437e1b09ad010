"""The benchmark's weights of the rel-pos conformer (``espnet-conformer``):
made from the seed on the device as ``weights.py`` makes the transformer's
(one normal draw, each leaf a scaled view of it), under the parameter names
of the port's ``SpeechTransformer`` with ``encoder_type`` "conformer",
``pos_enc_type`` "rel" and the conv2d frontend, and handed alike to the
program and to the plain reference (``reference/conformer.py``).

Distributions follow the port's initialisers: lecun-normal dense and
convolution kernels (fan-in: taps times input channels a group), zero
biases, xavier-normal ``pos_bias_u`` / ``pos_bias_v``, embeddings normal
with std 1/sqrt(d), unit LayerNorm scales."""

from __future__ import annotations

import math

import torch


def frontend_rows(n: int) -> int:
    """Rows of ``n`` left after the two valid 3x3 stride-2 convolutions."""
    return ((n - 1) // 2 - 1) // 2


def leaf_specs(model: dict, vocab_size: int) -> list:
    """[(name, shape, std)] of every parameter; std 0 is a zero bias, None
    a unit LayerNorm scale."""
    d, ff, h, dk = model["d_model"], model["d_ff"], model["num_heads"], model["head_dim"]
    inner, c, k = h * dk, model["frontend_channels"], model["conv_kernel_size"]
    specs = []

    def dense(name, n_in, n_out, bias=True):
        specs.append((f"{name}.weight", (n_out, n_in), n_in ** -0.5))
        if bias:
            specs.append((f"{name}.bias", (n_out,), 0.0))

    def norm(name):
        specs.append((f"{name}.weight", (d,), None))
        specs.append((f"{name}.bias", (d,), 0.0))

    def attention(name):
        for proj in ("q_proj", "k_proj", "v_proj"):
            dense(f"{name}.{proj}", d, inner)
        dense(f"{name}.out_proj", inner, d)

    f = "encoder.frontend_mod"
    specs += [(f"{f}.conv0.weight", (c, 1, 3, 3), 9 ** -0.5), (f"{f}.conv0.bias", (c,), 0.0),
              (f"{f}.conv1.weight", (c, c, 3, 3), (9 * c) ** -0.5),
              (f"{f}.conv1.bias", (c,), 0.0)]
    dense(f"{f}.proj", frontend_rows(model["input_dim"]) * c, d)
    for i in range(model["num_encoder_layers"]):
        p = f"encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            dense(f"{p}.{ffn}.w1", d, ff)
            dense(f"{p}.{ffn}.w2", ff, d)
        attention(f"{p}.attn")
        dense(f"{p}.attn.linear_pos", d, inner, bias=False)
        specs.append((f"{p}.attn.pos_bias_u", (h, dk), (2.0 / (h + dk)) ** 0.5))
        specs.append((f"{p}.attn.pos_bias_v", (h, dk), (2.0 / (h + dk)) ** 0.5))
        dense(f"{p}.conv.pw1", d, 2 * d)
        specs += [(f"{p}.conv.dw.weight", (d, 1, k), k ** -0.5), (f"{p}.conv.dw.bias", (d,), 0.0)]
        norm(f"{p}.conv.norm")
        dense(f"{p}.conv.pw2", d, d)
        for ln in ("ln_ffn1", "ln_attn", "ln_conv", "ln_ffn2", "ln_final"):
            norm(f"{p}.{ln}")
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
    norm("decoder.final_norm")
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
