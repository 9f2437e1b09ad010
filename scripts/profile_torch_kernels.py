#!/usr/bin/env python
"""The PyTorch port's fbank (K5), CTC (K3, K4) and CTC prefix (K8, K9)
kernels on one GPU, kernel by kernel: what ``nvcc -Xptxas -v`` says of each
kernel of ``fbank.cu``, ``ctc.cu``, ``ctc_prefix.cu`` and
``ctc_prefix_beam.cu`` (registers, static shared memory, spills),
then the device time of each kernel that one call of a wrapper launches,
under ``torch.profiler``: K5 at the training batch (64, 128000) and the
serving batch (8, 128000) f32, K3 and K4 at the flagship's CTC shape (64,
267, 4233) bf16 with label pad 32 (S = 65) and at (8, 501, 4233) with label
pad 200 (S = 401), K8 at the serving batch (8, 10, 288) and the bench
decode's (64, 10, 267), K9 at beam 10, prune 8, L 64 on peaky rows of
(8, 288, 4233) and (8, 512, 4233). How a wrapper's time splits over its launches
(``chip_smoke.py`` times the wrappers as wholes): K3's row pass
(``ctc_emission_rows_kernel``) and recursion (``ctc_alpha_recursion_kernel``),
K4's recursion (``ctc_beta_recursion_kernel``) and gradient rows
(``ctc_grad_rows_kernel``), K9's row pass (``prefix_beam_rows_kernel``)
and recursion (``prefix_beam_recursion_kernel``).

    python3 scripts/profile_torch_kernels.py

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc as ctc_ops  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel as ctc  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel  # noqa: E402

SOURCES = ("fbank.cu", "ctc.cu", "ctc_prefix.cu", "ctc_prefix_beam.cu")
N_CALLS = 20


def print_resources() -> None:
    """One line per kernel of the sources from ``nvcc -Xptxas -v``."""
    with tempfile.TemporaryDirectory() as tmp:
        for src in SOURCES:
            res = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 str(_build.CSRC / src), "-o", os.path.join(tmp, "x.o")],
                capture_output=True, text=True, check=True,
            )
            lines = res.stderr.splitlines()
            for i, line in enumerate(lines):
                name = re.search(r"Compiling entry function '(\w+)'", line)
                if name:
                    info = " ".join(x.replace("ptxas info    :", "").strip()
                                    for x in lines[i + 1 : i + 4]
                                    if "Used" in x or "spill" in x)
                    print(f"{src} {name.group(1)[:80]}: {info}")


def profile_calls(what, fn) -> None:
    """Device us per call of each kernel that ``N_CALLS`` calls of ``fn``
    launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with chip_smoke._traced() as prof:
        for _ in range(N_CALLS):
            fn()
    print(f"{what}: device us per launch under the profiler ({N_CALLS} calls; the "
          f"launches it listed per call)")
    total = 0.0
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and e.count and chip_smoke.WARMUP_KERNEL not in e.key:
            us = e.self_device_time_total / e.count
            per_call = e.count / N_CALLS
            total += us * round(per_call)
            print(f"{us:10.1f}  ({per_call:.2f} per call)  {e.key[:90]}")
    print(f"{total:10.1f}  in all, per call")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_kernels: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    print_resources()
    dev = torch.device("cuda", 0)
    cfg = FeatureConfig()
    rng = np.random.RandomState(0)
    for shape in ((64, 128000), (8, 128000)):
        pcm = rng.randint(-32768, 32768, size=shape).astype(np.int16)
        wave = torch.from_numpy(pcm).to(dev).float() * (1.0 / 32768.0)
        profile_calls(f"K5 fbank {shape} f32", lambda: log_mel_spectrogram_kernel(wave, cfg))
    for b, t, label_pad in ((64, 267, 32), (8, 501, 200)):
        logits, lens, labels, lab_lens = chip_smoke._ctc_inputs(
            dev, torch.bfloat16, b=b, t=t, label_pad=label_pad)
        ext = ctc_ops.extend_labels(labels.long())
        ext, lens, lab_lens = ctc._check_kernel_inputs(logits, ext, lens, lab_lens)
        loss, alpha, lse = ctc.ctc_alpha_kernel(logits, ext, lens, lab_lens)
        g = torch.linspace(0.5, 1.5, b, device=dev)
        shape = f"({b}, {t}, 4233) bf16, S = {ext.shape[1]}"
        profile_calls(f"K3 CTC alpha (ctc_emission_rows_kernel + ctc_alpha_recursion_kernel) "
                      f"{shape}",
                      lambda: ctc.ctc_alpha_kernel(logits, ext, lens, lab_lens))
        profile_calls(f"K4 CTC beta + gradient {shape}",
                      lambda: ctc.ctc_beta_kernel(
                          logits, ext, lens, lab_lens, lse, alpha, loss, g))
    for b, k, t in ((8, 10, 288), (64, 10, 267)):
        args = chip_smoke._k8_inputs(dev, b, k, t, seed=t)
        profile_calls(f"K8 ctc prefix registers ({b}, {k}, {t}) f32",
                      lambda: chip_smoke.k8.ctc_selected_registers(*args, False))
    for t in (288, 512):
        lp, lens = chip_smoke._peaky_rows(dev, 8, t, seed=t)
        profile_calls(f"K9 ctc prefix beam (8, {t}, 4233) f32, beam 10, prune 8",
                      lambda: chip_smoke.ctc_prefix_beam_device(lp, lens, **chip_smoke.K9_ARGS))


if __name__ == "__main__":
    main()
