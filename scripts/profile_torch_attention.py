#!/usr/bin/env python
"""The PyTorch port's attention kernels on one GPU, kernel by kernel: the
full-tile K1 forward and K2 backward, and the windowed causal-band K6
forward and K7 backward. What ``nvcc -Xptxas -v`` says of the tensor-core
kernels (registers, static shared memory, spills; the windowed kernels'
shared memory is dynamic and not in that line), then at the training shape
(64, 8, 267, 64) bf16, with hash dropout 0.1 and with none, the device time
of each kernel of one forward + backward under ``torch.profiler``: K1/K2
without a mask (the flagship), then K6/K7 and K1/K2 on the streaming
model's causal band 50. How a backward's time splits over its two passes,
and what the hash costs. (``chip_smoke.py`` times the entry points as
wholes.)

    python3 scripts/profile_torch_attention.py

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import os
import re
import subprocess
import sys
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402

SOURCES = ("fused_attention_fwd.cu", "fused_attention_bwd.cu", "banded_attention.cu")
BATCH, FRAMES = 64, 267  # the training batch of 8 s utterances
BAND = 50  # the streaming model's causal band


def print_resources() -> None:
    """One line per tensor-core kernel from ``nvcc -Xptxas -v``."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            res = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(_build.CSRC / src), "-o", os.path.join(tmp, "x.o")],
                capture_output=True, text=True, check=True,
            )
            lines = res.stderr.splitlines()
            for i, line in enumerate(lines):
                name = re.search(
                    r"((?:attention|banded)_(?:fwd|bwd_dq|bwd_dkdv)_mma_kernel)ILi(\d+)ELb(\d)E",
                    line)
                if "Compiling entry function" in line and name:
                    info = " ".join(x.replace("ptxas info    :", "").strip()
                                    for x in lines[i + 1 : i + 4]
                                    if "Used" in x or "spill" in x)
                    print(f"{name.group(1)}, head dim {name.group(2)}, dropout "
                          f"{'on' if name.group(3) == '1' else 'off'}: {info}")


def profile_pair(what, fwd, bwd) -> None:
    """Device us per launch of each kernel of 20 forward + backward pairs."""
    for _ in range(3):
        fwd(), bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fwd(), bwd()
        torch.cuda.synchronize()
    print(f"{what}: device us per launch under the profiler (20 launches)")
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            print(f"{e.self_device_time_total / e.count:10.1f}  {e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_attention: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    print_resources()
    dev = torch.device("cuda", 0)
    q, k, v, q_len, k_len = chip_smoke._attn_inputs(
        BATCH, chip_smoke.HEADS, FRAMES, FRAMES, 64, dev, 17)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    gb = torch.randn_like(qb)
    shape = f"({BATCH}, {chip_smoke.HEADS}, {FRAMES}, 64) bf16"
    for causal, band in ((False, 0), (True, BAND)):
        for rate in (0.1, 0.0):
            call = (q_len, k_len, 777, 0.125, rate, causal, band)
            fwd = chip_smoke._attention_fwd_entry(qb, kb, vb, *call)
            fwd()
            bwd = chip_smoke._attention_bwd_entry(
                qb, kb, vb, fwd.out, fwd.stats, *call, gb, fwd.out_lo)
            mask = f"causal band {band}" if band else "no mask"
            profile_pair(f"K1/K2 {shape}, {mask}, hash dropout {rate}", fwd, bwd)
    for rate in (0.1, 0.0):
        fwd = chip_smoke._banded_fwd_entry(qb, kb, vb, k_len, 777, 0.125, rate, BAND)
        fwd()
        bwd = chip_smoke._banded_bwd_entry(
            qb, kb, vb, fwd.lse, k_len, 777, 0.125, rate, BAND, gb)
        profile_pair(f"K6/K7 {shape}, causal band {BAND}, hash dropout {rate}", fwd, bwd)


if __name__ == "__main__":
    main()
