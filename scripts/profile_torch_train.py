#!/usr/bin/env python
"""Device-time breakdown of the PyTorch port's train step on one GPU: the
recipe and fixed batch of ``chip_smoke.py``'s throughput phases (64 x 8
s, bf16, CTC 0.3 through the kernels; ``flagship``: hash dropout 0.1 and
SpecAugment; ``conformer``: the same recipe with the registry's
``Conformer`` (conformer blocks, conv kernel 15, pre-LN);
``streaming``: the causal band-50 pre-LN recipe, whose encoder attention
takes K6/K7 when ``ASR_BANDED_WINDOW=1`` and K1/K2 otherwise), 3 warm-up
steps, then ``--steps`` steps under
``torch.profiler``. Prints the card, the wall and device time per step,
the device time of a few groups of operators (the depthwise and conv2d
convolutions, GLU, swish, LayerNorm, each forward and backward), that of
the hash dropout masks (``hash_keep_mask``'s calls in the profiled
steps, counted by shape and made again alone under the profiler), the
operators with the
most device time (self time, per step) and the kernels with the most
device time.

    python3 scripts/profile_torch_train.py [--recipe flagship|conformer] [--steps 3] [--top 25]
    ASR_BANDED_WINDOW=1 python3 scripts/profile_torch_train.py --recipe streaming

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import argparse
import collections
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from asr_chinese_e2e_tpu_torch.models import layers  # noqa: E402

# operator groups by name (self device time of the ops whose name holds one
# of the words; each kernel is counted once, under the op that launched it)
GROUPS = {
    # a depthwise conv runs ATen's conv_depthwise2d kernels, not cuDNN
    "convolutions": ("convolution", "conv_depthwise"),
    "GLU": ("glu",),
    "swish": ("silu",),
    "LayerNorm": ("layer_norm",),
}


def _counted_hash_masks():
    """Count the hash dropout's mask calls by (shape, rate, dtype). The mask
    is made in the forward only (the backward multiplies by the saved
    mask), so its calls are its whole cost. Returns (counter, the unwrapped
    function)."""
    calls = collections.Counter()
    inner = layers.hash_keep_mask

    def counted(seed, shape, rate, dtype, device):
        calls[tuple(shape), rate, dtype] += 1
        return inner(seed, shape, rate, dtype, device)

    layers.hash_keep_mask = counted
    return calls, inner


def _hash_masks_ms(calls, make_mask, steps, dev) -> float:
    """Device ms a step of the counted masks: the same calls made again
    outside the step under the profiler, their kernels' device time
    summed."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for (shape, rate, dtype), n in calls.items():
            for _ in range(n):
                make_mask(1234, shape, rate, dtype, dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    return sum(_device_us(e) for e in kernels) / 1e3 / steps


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
    ap.add_argument("--recipe", choices=("flagship", "conformer", "streaming"), default="flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.recipe == "flagship":
        train_step, state, batch, _ = chip_smoke.flagship_train_setup(dev)
    elif args.recipe == "conformer":
        train_step, state, batch, _ = chip_smoke.flagship_train_setup(
            dev, **chip_smoke.CONFORMER)
    else:
        train_step, state, batch = chip_smoke.streaming_train_setup(dev)
    print(f"recipe {args.recipe}, "
          f"ASR_BANDED_WINDOW={os.environ.get('ASR_BANDED_WINDOW', 'unset')}")
    calls, make_mask = _counted_hash_masks()
    for _ in range(3):
        state, _ = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    calls.clear()
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
    ms = _hash_masks_ms(calls, make_mask, args.steps, dev)
    print(f"{ms:14.3f} {ms / total_ms * 100:5.1f}%  hash dropout masks: "
          f"{sum(calls.values()) / args.steps:.0f} a step in {len(calls)} shapes, made "
          f"again alone")
    _print_rows("operator", ops, args.steps, total_ms, args.top)
    _print_rows("kernel", kernels, args.steps, total_ms, args.top)


if __name__ == "__main__":
    main()
