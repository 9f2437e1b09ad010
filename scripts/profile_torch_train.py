#!/usr/bin/env python
"""Device-time breakdown of the PyTorch port's train step on one GPU: the
recipe and fixed batch of ``chip_smoke.py``'s throughput phases (64 x 8
s, bf16, CTC 0.3 through the kernels; ``flagship``: hash dropout 0.1 and
SpecAugment; ``conformer``: the same recipe with the registry's
``Conformer`` (conformer blocks, conv kernel 15, pre-LN);
``streaming``: the causal band-50 pre-LN recipe, whose encoder attention
takes K6/K7 when ``ASR_BANDED_WINDOW=1`` and K1/K2 otherwise;
``bilstm_ctc`` and ``las``: the RNN family at its registry widths in f32,
rng dropout 0.1, its CTC weight), 3 warm-up steps, then ``--steps`` steps
under ``torch.profiler``. Prints the card, the wall and device time per
step, the device time of a few groups of operators (the depthwise and
conv2d convolutions, GLU, swish, LayerNorm, the LSTMs, each forward and
backward), that of the hash dropout kernel (K10, forward and backward),
the operators with the most device time (self time, per step) and the
kernels with the most device time.

    python3 scripts/profile_torch_train.py [--recipe flagship|conformer|bilstm_ctc|las]
        [--steps 3] [--top 25]
    ASR_BANDED_WINDOW=1 python3 scripts/profile_torch_train.py --recipe streaming

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

# operator groups by name (self device time of the ops whose name holds one
# of the words; each kernel is counted once, under the op that launched it)
GROUPS = {
    # a depthwise conv runs ATen's conv_depthwise2d kernels, not cuDNN
    "convolutions": ("convolution", "conv_depthwise"),
    "GLU": ("glu",),
    "swish": ("silu",),
    "LayerNorm": ("layer_norm",),
    # cuDNN's recurrences (nn.LSTM) and the decoder's fused cell (LSTMCell)
    "LSTM": ("cudnn_rnn", "lstm"),
}
RNN_RECIPES = {"bilstm_ctc": "BiLSTMCTC", "las": "LAS"}


def _device_us(event) -> float:
    # called self_cuda_time_total in older torch
    if hasattr(event, "self_device_time_total"):
        return event.self_device_time_total
    return event.self_cuda_time_total


def _print_rows(title, events, steps, total_ms, top) -> None:
    print(f"{'device ms/step':>14} {'share':>6} {'calls/step':>10}  {title}")
    for e in events[:top]:
        ms = _device_us(e) / 1e3 / steps
        print(f"{ms:14.3f} {ms / total_ms * 100:5.1f}% {e.count / steps:10.1f}  "
              f"{e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", choices=("flagship", "conformer", "streaming", *RNN_RECIPES),
                    default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.recipe in RNN_RECIPES:
        train_step, state, batch, _ = chip_smoke.flagship_train_setup(
            dev, "float32", model_name=RNN_RECIPES[args.recipe])
    elif args.recipe == "flagship":
        train_step, state, batch, _ = chip_smoke.flagship_train_setup(dev)
    elif args.recipe == "conformer":
        train_step, state, batch, _ = chip_smoke.flagship_train_setup(
            dev, **chip_smoke.CONFORMER)
    else:
        train_step, state, batch = chip_smoke.streaming_train_setup(dev)
    print(f"recipe {args.recipe}, "
          f"ASR_BANDED_WINDOW={os.environ.get('ASR_BANDED_WINDOW', 'unset')}")
    for _ in range(3):
        state, _ = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = train_step(state, *batch, 0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if _device_us(e) > 0]
    events.sort(key=_device_us, reverse=True)
    # device events are the kernels themselves; a host operator's self
    # device time is that of the kernels it launched, so only the kernels
    # are summed
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    total_ms = sum(_device_us(e) for e in kernels) / 1e3 / args.steps
    wall_ms = wall * 1e3 / args.steps
    print(f"per step ({args.steps} profiled): wall {wall_ms:.3f} ms, device "
          f"{total_ms:.3f} ms, device busy {total_ms / wall_ms * 100:.1f} % of wall")
    print(f"{'device ms/step':>14} {'share':>6}  group")
    for name, words in GROUPS.items():
        ms = sum(_device_us(e) for e in ops if any(w in e.key for w in words))
        ms = ms / 1e3 / args.steps
        print(f"{ms:14.3f} {ms / total_ms * 100:5.1f}%  {name}: ops holding {words}")
    k10 = [e for e in kernels if "hash_dropout_kernel" in e.key]
    ms = sum(_device_us(e) for e in k10) / 1e3 / args.steps
    print(f"{ms:14.3f} {ms / total_ms * 100:5.1f}%  hash dropout (K10): "
          f"{sum(e.count for e in k10) / args.steps:.0f} launches a step")
    _print_rows("operator", ops, args.steps, total_ms, args.top)
    _print_rows("kernel", kernels, args.steps, total_ms, args.top)


if __name__ == "__main__":
    main()
