#!/usr/bin/env python
"""K8, the joint search's CTC prefix registers kernel, on one GPU, by two
measures: the device time of ``ctc_prefix_registers_kernel`` per launch
under ``torch.profiler`` (20 calls), and 20 calls of the wrapper
``ctc_selected_registers`` back to back under CUDA events (median of 10),
at the shapes of ``chip_smoke.py`` phase 8b, (8, 10, 288), (8, 10, 512) and
(64, 10, 267), on that phase's inputs (``chip_smoke._k8_inputs``).

``--root`` names the checkout whose package and kernels are measured
(default: the one that holds this script), so that two versions of K8 are
timed on one card in one run, each in its own process:

    python3 scripts/profile_k8_torch.py [--root DIR]

The kernels are built from that checkout at first use.
"""

import argparse
import os
import statistics
import subprocess
import sys

SHAPES = ((8, 10, 288), (8, 10, 512), (64, 10, 267))
N_CALLS = 20
WARMUP_LAUNCHES = 64


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose K8 is measured")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke  # that checkout's

    if not torch.cuda.is_available():
        raise SystemExit("profile_k8_torch: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; checkout {root}")
    dev = torch.device("cuda", 0)
    for b, k, t in SHAPES:
        args = chip_smoke._k8_inputs(dev, b, k, t, seed=t)

        def call():
            return chip_smoke.k8.ctc_selected_registers(*args, False)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # spin kernels first: a process that has traced before can lose
            # the card's records of the first launches after a start
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(N_CALLS):
                call()
            torch.cuda.synchronize()
        kernel = [e for e in prof.key_averages()
                  if "ctc_prefix_registers_kernel" in e.key and e.count]
        if len(kernel) != 1:
            raise SystemExit(f"profile_k8_torch: the profiler saw {len(kernel)} K8 kernels")
        kernel_ms = kernel[0].self_device_time_total / kernel[0].count / 1e3
        samples = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(N_CALLS):
                call()
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / N_CALLS)
        print(f"K8 {(b, k, t)}: the kernel alone {kernel_ms:.4f} ms a launch (profiler, "
              f"{kernel[0].count} launches); {N_CALLS} wrapper calls back to back "
              f"{statistics.median(samples):.4f} ms a call (median of 10)")


if __name__ == "__main__":
    main()
