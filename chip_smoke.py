#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then drives the
serving path (``asr_chinese_e2e_tpu_torch.recognize``, beam mode) and the
training path (``asr_chinese_e2e_tpu_torch.main.train``) on the flagship
configuration with random weights, then trains and serves the streaming
model family (causal-banded encoder) through ``main.train`` and
``asr_chinese_e2e_tpu_torch.stream``, and checks that every path went
through its kernels. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. require CUDA; print the card (``nvidia-smi``); TF32 off;
2. build the kernels (``ops/_build.py``, one nvcc per source in parallel)
   and print the build time;
3. K5 fbank kernel vs ``log_mel_spectrogram``: log-mel abs diff and mel
   energy rel diff <= 1e-3, at the serving batch (8, 128000), the
   training batch (64, 128000) and an odd length. Here and in phases 4-7
   a kernel is timed in turns with its plain version and, where one
   PyTorch call computes the same function, that call (``library_ms``:
   ``F.scaled_dot_product_attention`` with a bool mask at dropout 0 for
   the attention kernels, its forward+backward minus its forward for the
   backward kernels; ``F.log_softmax`` + ``F.ctc_loss`` for CTC; none
   for the fbank), medians of CUDA-event times, and printed beside
   ``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
   its operations over the peak of their type (989.4 TFLOP/s bf16 tensor
   cores, 67 TFLOP/s f32), from this run's shapes;
4. K1 attention kernel vs ``attention_reference``: f32 <= 1e-4 abs, bf16
   (the tensor-core kernel) vs the f32 reference of the same bf16 inputs
   <= 2e-2 abs, at the serving encoder shapes (8, 8, 267|501, 64), the
   causal / band / rectangular / dropout cases, the training encoder
   shape (64, 8, 267, 64) with hash dropout 0.1, head dim 32, a single
   query row over 267 keys, and a causal band 50 whose keys end 50 rows
   before the queries do; at the training and serving shapes
   also the time of the scalar-FMA build of the bf16 kernel (the design
   it replaced), in turns with the rest;
5. K2 attention backward (through the autograd Function, after K1 saved
   the row log-sum-exp) vs ``attention_backward_reference``: dq, dk, dv
   f32 <= 1e-4 abs, bf16 <= 2e-2 abs of the f32 reference, same cases;
   the same times; with query rows that see no key at all (causal band
   20, 267 rows over 100, 30 and 1 keys) K1 must still agree and K2,
   which cannot recompute such a row's weights, must raise;
6. K6/K7 windowed causal-band attention (through the autograd Function
   with ``ASR_BANDED_WINDOW=1``) vs ``banded_attention_reference`` and
   ``banded_attention_backward_reference``, same bounds, at the streaming
   training shape (64, 8, 267, 64) band 50 with and without hash dropout
   0.1, the streaming serving shape (1, 8, 501, 64), (2, 8, 150, 64) band
   30 with lengths [150, 97], and bands 64 and 65 at T = 501; K6 vs K1 on
   the same f32 inputs with dropout 0.1 <= 1e-5 abs; median times of K6,
   its plain version and K1, and of K7, its plain version and K2, at the
   training shape;
7. K3/K4 CTC vs ``ctc_alpha_reference`` / ``ctc_beta_reference`` and the
   loss vs ``F.ctc_loss`` at (64, 267, 4233), ragged lengths, label pad
   32, f32 and bf16: loss rel <= 1e-4, gradient abs <= 1e-3 (f32; 1e-2
   in bf16, where both sides round the gradient to bf16); times;
8. the serving path: a 512-wide, 6+6-layer, bf16 SpeechTransformer with a
   4233-token vocabulary decodes 16 synthetic utterances of 2-8 s (beam
   10, batches of 8); every utterance needs a finite-scored hypothesis,
   the fbank kernel must run once and the attention kernel 6 times per
   batch, and the kernel path's f32 encoder output must agree with the
   CPU run of the plain path (which the CPU tests hold to the JAX
   package);
9. the training path: ``main.train`` with the flagship recipe (bf16,
   CTC 0.3 through K3/K4, fused attention with hash dropout 0.1,
   SpecAugment, Noam + Adam, clip 5) on 128 synthetic 8 s utterances (2
   batches of 64) and 16 dev utterances, 2 epochs; every logged loss
   finite; per train step K5 1, K1 6, K2 6, K3 1, K4 1 launches (plus
   K5 1, K1 6, K3 1 per dev batch); ``scalars.jsonl`` and ``index.json``
   written; a second ``train(from_ckpt="latest", num_epoch=3)`` resumes
   at the saved step and epoch; the best checkpoint decodes the dev set
   through ``recognize`` on the card;
10. one f32 flagship-width train step (2 utterances, no dropout, no
    SpecAugment) on the card vs the same step on the CPU's plain path:
    loss and gradient norm within 1e-3 relative;
11. streaming training: with ``ASR_BANDED_WINDOW=1``, ``main.train`` with
    the streaming recipe of ``artifacts/r5_streaming/config.json``
    (flagship widths, pre-LN, causal band 50, fixed CMVN, dropout 0, CTC
    0.3, bf16, Noam factor 0.25 warmup 150) on the corpus of phase 9, 2
    epochs; every logged loss finite; per train step K5 1, K6 6, K7 6,
    K3 1, K4 1 and no K1/K2 launch (per dev batch K5 1, K6 6, K3 1); the
    best checkpoint written;
12. streaming serving: that checkpoint through ``load_experiment`` into
    ``StreamingRecognizer``; 4 streams (``reset_stream`` between them) of
    3 synthetic 2-4 s utterances, each padded to whole 125 ms chunks and
    followed by 1 s of zeros, fed in 2000-sample chunks, partials every
    1 s; prefix re-encode (``ASR_BANDED_WINDOW=1``: each encode launches
    K5 1 and K6 6) and incremental (no kernel launch), each with
    ``ctc_greedy`` and ``beam`` (10) finals, in bf16 and in f32 (the same
    weights); in f32 the incremental finals must equal the prefix
    re-encode finals and the accumulated incremental encoder output must
    be within 1e-3 of the offline encode of the bucketed segment; in
    bf16 the number of agreeing finals is printed; median and p90 ms of
    a partial and of a final in each mode;
13. throughput: 20 timed flagship steps on one fixed batch of 64 x 8 s
    after 3 warm-up steps: ms per step, steps/s, audio-s/s and MFU
    against the H100 SXM dense bf16 peak;
14. streaming throughput: the streaming recipe on one fixed batch of
    64 x 8 s, 3 warm-up then 20 timed steps with ``ASR_BANDED_WINDOW=1``
    (K6/K7) and then ``=0`` (K1/K2), back to back: ms per step and
    audio-s/s of each;
15. print the kernels' JSON line (per kernel: route, source, the TPU
    kernel it replaces, launches on the main paths and per flagship
    train step, streaming train step and serving batch, and at the
    training shape ``shape``, ``max_abs_err``, ``ms``, ``plain_ms``,
    ``bound_ms``, ``bound_by``, ``library_ms``; ``other_shapes`` holds
    the same for the serving shapes), the card line, and last
    ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from asr_chinese_e2e_tpu_torch.core.config import Config  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import (  # noqa: E402
    FeatureConfig,
    log_mel_spectrogram,
    mel_filterbank,
    parse_batch,
)
from asr_chinese_e2e_tpu_torch.data.io import load_wav  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.manifest import read_manifest  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.main import train as main_train  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import (  # noqa: E402
    SpeechTransformer,
    default_config,
)
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc as ctc_ops  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel as ctc  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel  # noqa: E402
from asr_chinese_e2e_tpu_torch.recognize import recognize  # noqa: E402
from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer  # noqa: E402
from asr_chinese_e2e_tpu_torch.train.optimizer import (  # noqa: E402
    default_train_config,
    make_optimizer,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.experiment import (  # noqa: E402
    checkpoint_path,
    load_experiment,
    save_torch_checkpoint,
)
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
N_TIMED = 30
# NVIDIA H100 SXM datasheet: dense bf16 tensor-core peak, FLOP/s
H100_SXM_BF16_PEAK = 989.4e12
# same datasheet: f32 outside the tensor cores, FLOP/s; device memory, bytes/s
H100_SXM_F32_PEAK = 67e12
H100_SXM_BYTES_PER_S = 3.35e12
VOCAB = 4233

# every kernel wrapper's launch counter, by the kernel's name
COUNTERS = {
    "fbank": log_mel_spectrogram_kernel,
    "fused_attention_fwd": fa.fused_attention_general,
    "fused_attention_bwd": fa.attention_backward_kernel,
    "banded_attention_fwd": fa.banded_attention_kernel,
    "banded_attention_bwd": fa.banded_attention_backward_kernel,
    "ctc_alpha": ctc.ctc_alpha_kernel,
    "ctc_beta": ctc.ctc_beta_kernel,
}


def reset_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _event_times(fn, n, warmup, reps=1) -> list:
    """``n`` CUDA-event times of ``reps`` back-to-back calls of ``fn``, each
    divided by ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return times


def median_ms(fn, n=N_TIMED, warmup=3) -> float:
    """Median of ``n`` CUDA-event-timed calls of ``fn``."""
    return statistics.median(_event_times(fn, n, warmup))


def turns_ms(fns: dict, n=N_TIMED // 2, warmup=2, reps=1) -> dict:
    """Median CUDA-event time of each function, timed in turns: a, b, ...,
    z, z, ..., b, a, ``n`` samples a visit, so that a drift of the card's
    clocks falls on all alike. With ``reps`` > 1 a sample is that many
    back-to-back calls, which hides the host's time per call behind the
    device's: the device time of a kernel shorter than its wrapper."""
    samples = {k: [] for k in fns}
    for name in list(fns) + list(fns)[::-1]:
        samples[name] += _event_times(fns[name], n, warmup, reps)
    return {k: statistics.median(v) for k, v in samples.items()}


# -- the least time the card could take (``bound_ms``) ---------------------------


def bound(n_bytes: float, flops: float, peak: float) -> dict:
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type, in ms, and which of the two it was."""
    by_bytes = n_bytes / H100_SXM_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return {
        "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bytes": n_bytes, "flops": flops,
    }


def band_pairs(lengths, heads: int, band: int) -> int:
    """(query, key) pairs a causal band leaves visible: row i < n sees
    min(i, band) + 1 keys."""
    return heads * sum(
        sum(min(i, band) + 1 for i in range(int(n))) for n in lengths
    )


def _attention_bound(q_side, k_side, n_products, b, h, tq, tk, d, itemsize, pairs):
    """``q_side`` tensors of (B, H, Tq, D) and ``k_side`` of (B, H, Tk, D),
    each moved once; ``n_products`` products over the (query, key) pairs.
    The (B, H, Tq) f32 log-sum-exp, under 1 % of the bytes, is left out."""
    pairs = b * h * tq * tk if pairs is None else pairs
    peak = H100_SXM_BF16_PEAK if itemsize == 2 else H100_SXM_F32_PEAK
    n_bytes = itemsize * b * h * d * (q_side * tq + k_side * tk)
    return bound(n_bytes, n_products * 2.0 * pairs * d, peak)


def attention_fwd_bound(b, h, tq, tk, d, itemsize=2, pairs=None) -> dict:
    """K1, K6: q, k, v read and the output written once; the two products
    Q K^T and W V over the (query, key) pairs (all of them, or ``pairs``
    where a window leaves fewer). bf16 on the tensor cores, f32 on FMAs."""
    return _attention_bound(2, 2, 2, b, h, tq, tk, d, itemsize, pairs)


def attention_bwd_bound(b, h, tq, tk, d, itemsize=2, pairs=None) -> dict:
    """K2: q, k, v, o, dO read and dq, dk, dv written once; the five
    products S, dP, dV, dQ, dK."""
    return _attention_bound(4, 4, 5, b, h, tq, tk, d, itemsize, pairs)


def banded_attention_bwd_bound(b, h, t, d, itemsize=2, pairs=None) -> dict:
    """K7: as K2 without the forward output, which it does not take: q, k,
    v, dO read and dq, dk, dv written once."""
    return _attention_bound(3, 4, 5, b, h, t, t, d, itemsize, pairs)


def fbank_bound(b, n_samples, cfg=None) -> dict:
    """K5: the waveform read, the log-mel written, f32; the operations the
    function needs per frame, whatever the kernel does: the window, a real
    FFT of n_fft points (2.5 n log2 n), the power of each bin, the non-zero
    taps of the triangular mel filters, and the log."""
    cfg = cfg or FeatureConfig()
    frames = b * cfg.num_frames(n_samples)
    n_bins = cfg.n_fft // 2 + 1
    mel_taps = int(np.count_nonzero(mel_filterbank(cfg)))
    per_frame = (cfg.win_length + 2.5 * cfg.n_fft * np.log2(cfg.n_fft) + 3.0 * n_bins
                 + 2.0 * mel_taps + cfg.n_mels)
    return bound(4.0 * (b * n_samples + frames * cfg.n_mels), float(frames * per_frame),
                 H100_SXM_F32_PEAK)


def ctc_alpha_bound(b, t, c, s, itemsize=2) -> dict:
    """K3: the logits read; the (B, T, S) f32 alpha table, the (B, T) f32
    log-sum-exp and the loss written; max, subtract, exp, add per logit and
    the three-way log-add-exp per table cell, in f32."""
    n_bytes = itemsize * b * t * c + 4.0 * (b * t * s + b * t + b)
    return bound(n_bytes, 4.0 * b * t * c + 8.0 * b * t * s, H100_SXM_F32_PEAK)


def ctc_beta_bound(b, t, c, s, itemsize=2) -> dict:
    """K4: the logits, alpha, log-sum-exp and loss read; the gradient written
    in the logits' type; softmax minus occupancy per logit, in f32."""
    n_bytes = 2.0 * itemsize * b * t * c + 4.0 * (b * t * s + b * t + 2 * b)
    return bound(n_bytes, 4.0 * b * t * c + 12.0 * b * t * s, H100_SXM_F32_PEAK)


def _measured(shape, err, times: dict, limits: dict) -> dict:
    """One shape's entry of the kernels' line: what was timed, beside the
    bound computed from this run's inputs."""
    return {
        "shape": shape, "max_abs_err": err, "ms": times["kernel"],
        "plain_ms": times["plain"], "bound_ms": limits["bound_ms"],
        "bound_by": limits["bound_by"], "library_ms": times.get("library"),
    }


def _device_times(what, shape, device: dict, limits: dict) -> dict:
    """Print and return the device times of the tensor-core kernel and of the
    scalar-FMA design it replaced, launched back to back through their C
    entry points, in turns."""
    print(f"{what} {shape} bf16, device time of the entry point alone ({DEVICE_REPS} "
          f"launches back to back, in turns, median of 10): tensor-core kernel "
          f"{device['kernel']:.4f} ms ({limits['bound_ms'] / device['kernel'] * 100:.1f} % "
          f"of the bound), scalar-FMA design {device['fma']:.4f} ms "
          f"({device['fma'] / device['kernel']:.2f} x)")
    return {"device_ms": device["kernel"], "fma_device_ms": device["fma"]}


def _print_times(what, shape, times: dict, limits: dict) -> None:
    parts = [f"{k} {v:.4f} ms" for k, v in times.items()]
    print(f"{what} {shape}: " + ", ".join(parts) + f"; bound {limits['bound_ms']:.4f} ms "
          f"by {limits['bound_by']} ({limits['bytes'] / 1e6:.1f} MB, "
          f"{limits['flops'] / 1e9:.2f} GFLOP): kernel at "
          f"{limits['bound_ms'] / times['kernel'] * 100:.1f} % of it (in turns, median of "
          f"{2 * (N_TIMED // 2)})")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def banded_window(value: str):
    """Set ``ASR_BANDED_WINDOW`` for the phases of the streaming slice only,
    and restore it after, so the other phases keep the full-tile route."""
    old = os.environ.get("ASR_BANDED_WINDOW")
    os.environ["ASR_BANDED_WINDOW"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ASR_BANDED_WINDOW", None)
        else:
            os.environ["ASR_BANDED_WINDOW"] = old


# -- phase 3: fbank ------------------------------------------------------------


def check_fbank(dev) -> dict:
    cfg = FeatureConfig()
    rng = np.random.RandomState(0)
    worst, timed = 0.0, {}
    for shape in ((8, 128000), (64, 128000), (3, 12345)):
        pcm = rng.randint(-32768, 32768, size=shape).astype(np.int16)
        wave = torch.from_numpy(pcm).to(dev).float() * (1.0 / 32768.0)
        got = log_mel_spectrogram_kernel(wave, cfg)
        want = log_mel_spectrogram(wave, cfg)
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"fbank shape {got.shape} vs {want.shape}")
        diff = (got - want).abs()
        max_abs = diff.max().item()
        # relative error of the mel energies, exp(got) vs exp(want): a
        # log-domain relative error is undefined where the log mel crosses 0
        max_rel = torch.expm1(diff).max().item()
        log_rel = (diff / want.abs().clamp(min=1e-6)).max().item()
        print(f"fbank {shape}: max_abs={max_abs:.3e} energy max_rel={max_rel:.3e} "
              f"(log-domain max_rel {log_rel:.3e}, not a bound)")
        require(max_abs <= 1e-3 and max_rel <= 1e-3, f"fbank {shape} disagrees")
        worst = max(worst, max_abs)
        if shape[1] == 128000:
            times = turns_ms({
                "kernel": lambda: log_mel_spectrogram_kernel(wave, cfg),
                "plain": lambda: log_mel_spectrogram(wave, cfg),
            })
            limits = fbank_bound(*shape, cfg)
            _print_times("fbank f32", shape, times, limits)
            timed[shape] = _measured(list(shape), max_abs, times, limits)
    # no single PyTorch call computes framing + DFT + mel + log: no library time
    return {**timed[64, 128000], "max_abs_err": worst, "other_shapes": [timed[8, 128000]]}


# -- phase 4: attention --------------------------------------------------------


def _attn_inputs(b, h, tq, tk, d, dev, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, tq, d, generator=g)
    k = torch.randn(b, h, tk, d, generator=g)
    v = torch.randn(b, h, tk, d, generator=g)
    if b > 8:  # the training batch: 7.5-8 s utterances, the last 17 frames ragged
        q_len = torch.tensor([tq - (7 * i) % 18 for i in range(b)], dtype=torch.int32)
        k_len = torch.tensor([tk - (7 * i) % 18 for i in range(b)], dtype=torch.int32)
        return [x.to(dev) for x in (q, k, v, q_len, k_len)]
    q_len = torch.tensor([max(1, tq - 37 * i) for i in range(b)], dtype=torch.int32)
    k_len = torch.tensor([max(1, tk - 37 * i) for i in range(b)], dtype=torch.int32)
    if tq != tk:  # cross-attention: queries by target length, keys by frames
        q_len = torch.tensor([max(1, tq - 3 * i) for i in range(b)], dtype=torch.int32)
    return [x.to(dev) for x in (q, k, v, q_len, k_len)]


# (name, batch, tq, tk, causal, band, rate, head dim): the serving encoder at
# batch 8, the masks K1/K2 take, the training encoder (batch 64, dropout
# 0.1), the edges a 64-row tile gets wrong first, and a causal band whose keys
# end ``band`` before the queries do (``short_keys``: the last row still sees
# one key, and the tile ranges skip on both sides)
ATTENTION_CASES = [
    ("encoder-8s", 8, 267, 267, False, 0, 0.0, 64),
    ("encoder-15s", 8, 501, 501, False, 0, 0.0, 64),
    ("causal", 8, 267, 267, True, 0, 0.0, 64),
    ("band50", 8, 267, 267, False, 50, 0.0, 64),
    ("causal-band50", 8, 267, 267, True, 50, 0.0, 64),
    ("rectangular", 8, 21, 267, False, 0, 0.0, 64),
    ("dropout0.1", 8, 267, 267, False, 0, 0.1, 64),
    ("train-dropout0.1", 64, 267, 267, False, 0, 0.1, 64),
    ("head-dim-32", 8, 267, 267, False, 0, 0.1, 32),
    ("single-query", 8, 1, 267, False, 0, 0.0, 64),
    ("causal-band50-short-keys", 8, 267, 267, True, 50, 0.0, 64),
]
# timed: the training shape first (the kernels' line reports it), then the
# serving shapes
TIMED_ATTENTION = ("train-dropout0.1", "encoder-8s", "encoder-15s")
HEADS = 8


def _attention_fwd_entry(symbol, q, k, v, q_len, k_len, seed, scale, rate, causal, band):
    """A closure that launches the C entry point ``symbol`` (``asr_attention_fwd``,
    or ``asr_attention_fwd_fma``: the scalar-FMA build of the bf16 kernel, what
    K1 was before the tensor-core design) into buffers made once, which it
    carries as ``launch.out`` and ``launch.lse``. For timing only: no
    counter, no input checks, no allocation."""
    fn = getattr(_build.load_library(), symbol)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        *q.shape[:3], k.shape[2], q.shape[3], int(q.dtype == torch.bfloat16),
        float(scale), *fa._dropout_args(seed, rate), int(causal), int(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream), symbol)

    # the pointers in argv stay valid as long as the closure lives
    launch.inputs, launch.out, launch.lse = (q, k, v, q_len, k_len), out, lse
    return launch


def _attention_bwd_entry(symbol, q, k, v, out, lse, q_len, k_len, seed, scale, rate,
                         causal, band, g):
    """The same for ``asr_attention_bwd`` / ``asr_attention_bwd_fma``."""
    fn = getattr(_build.load_library(), symbol)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), q_len.data_ptr(), k_len.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.shape[:3], k.shape[2], q.shape[3], int(q.dtype == torch.bfloat16),
        float(scale), *fa._dropout_args(seed, rate), int(causal), int(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream), symbol)

    launch.buffers = (q, k, v, out, lse, q_len, k_len, g, dq, dk, dv, delta)
    return launch


DEVICE_REPS = 20  # back-to-back launches per sample of a device time


def _sdpa_mask(q_len, k_len, tq, tk, causal, band):
    """Bool mask (True: take part) for ``F.scaled_dot_product_attention``
    with the kernels' key visibility: (B, 1, 1, Tk) key padding, or (B, 1,
    Tq, Tk) with the causal / band window."""
    dev = k_len.device
    kpos = torch.arange(tk, device=dev)[None, None, None, :]
    mask = kpos < k_len[:, None, None, None]
    qpos = torch.arange(tq, device=dev)[None, None, :, None]
    if causal:
        mask = mask & (kpos <= qpos)
        if band > 0:
            mask = mask & (qpos - kpos <= band)
    elif band > 0:
        mask = mask & ((qpos - kpos).abs() <= band)
    return mask


def _sdpa_library(q, k, v, mask, scale, g):
    """(forward, forward + backward) closures of the one PyTorch call that
    computes the kernels' function at dropout 0 (padded query rows not
    zeroed, no hash dropout). The yardstick ``library_ms``: timed here and
    called nowhere in the package."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def forward():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)

    def forward_backward():
        torch.autograd.grad(forward(), leaves, g)

    return forward, forward_backward


def short_keys(q_len, band):
    """Key lengths ``band`` under the query lengths, where that leaves more
    keys than the band is wide (else the last key gathers every row, and the
    bf16 rounding of so large a gradient alone passes the absolute bound)."""
    return torch.where(q_len > 2 * band, q_len - band, q_len)


def _attn_case(i, case, dev, seed0):
    name, b, tq, tk, causal, band, rate, d = case
    q, k, v, q_len, k_len = _attn_inputs(b, HEADS, tq, tk, d, dev, seed=seed0 + i)
    if name.endswith("short-keys"):
        k_len = short_keys(q_len, band)
    return q, k, v, q_len, k_len, d ** -0.5


def check_attention(dev) -> dict:
    worst, timed = 0.0, {}
    for i, case in enumerate(ATTENTION_CASES):
        name, b, tq, tk, causal, band, rate, d = case
        q, k, v, q_len, k_len, scale = _attn_case(i, case, dev, 0)
        args = (q_len, k_len, 1234, scale, rate, causal, band)
        got32 = fa.fused_attention_general(q, k, v, *args)
        want32 = fa.attention_reference(q, k, v, *args)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        got16 = fa.fused_attention_general(qb, kb, vb, *args)
        want16 = fa.attention_reference(qb.float(), kb.float(), vb.float(), *args)
        torch.cuda.synchronize()
        err32 = (got32 - want32).abs().max().item()
        err16 = (got16.float() - want16).abs().max().item()
        shape = [b, HEADS, tq, tk, d]
        print(f"attention {name} {shape}: f32 max_abs={err32:.3e} bf16 max_abs={err16:.3e}")
        require(err32 <= 1e-4, f"attention {name} f32 disagrees")
        require(err16 <= 2e-2 and bool(torch.isfinite(got16).all()),
                f"attention {name} bf16 disagrees")
        worst = max(worst, err16)
        if name in TIMED_ATTENTION:
            mask = _sdpa_mask(q_len, k_len, tq, tk, causal, band)
            library, _ = _sdpa_library(qb, kb, vb, mask, scale, None)
            with torch.no_grad():
                times = turns_ms({
                    "kernel": lambda: fa._launch(qb, kb, vb, *args),
                    "library": library,
                    "plain": lambda: fa.attention_reference(qb, kb, vb, *args),
                })
            device = turns_ms({
                "fma": _attention_fwd_entry("asr_attention_fwd_fma", qb, kb, vb, *args),
                "kernel": _attention_fwd_entry("asr_attention_fwd", qb, kb, vb, *args),
            }, n=5, reps=DEVICE_REPS)
            limits = attention_fwd_bound(b, HEADS, tq, tk, d)
            _print_times(f"attention {name} bf16 (library: SDPA, dropout 0)",
                         shape, times, limits)
            timed[name] = {**_measured(shape, err16, times, limits), **_device_times(
                f"attention {name}", shape, device, limits)}
    first, *others = (timed[n] for n in TIMED_ATTENTION)
    return {**first, "max_abs_err": worst, "other_shapes": others}


# -- phase 5: attention backward ----------------------------------------------


def _check_keyless_rows(dev) -> None:
    """Query rows more than the band past the key length see no key: K1
    gives them the mean of all Tk values, as the plain version does; K2,
    which recomputes the weights from the row log-sum-exp, must refuse."""
    q, k, v, q_len, _ = _attn_inputs(4, HEADS, 267, 267, 64, dev, seed=40)
    k_len = torch.tensor([267, 100, 30, 1], dtype=torch.int32, device=dev)
    q_len = torch.full_like(k_len, 267)
    args = (q_len, k_len, 5, 0.125, 0.1, True, 20)
    errs = []
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        leaves = [x.to(dtype).requires_grad_(True) for x in (q, k, v)]
        out = fa.fused_attention_general(*leaves, *args)
        want = fa.attention_reference(*(x.detach().float() for x in leaves), *args)
        errs.append((out.float() - want).abs().max().item())
        require(errs[-1] <= limit, f"attention with keyless rows, {dtype}: {errs[-1]:.3e}")
        before = fa.attention_backward_kernel.launches
        try:
            out.backward(torch.ones_like(out))
        except ValueError as e:
            require("sees no key" in str(e), f"attention bwd with keyless rows: {e}")
        else:
            raise AssertionError("attention bwd with keyless rows did not refuse")
        require(fa.attention_backward_kernel.launches == before, "K2 launched all the same")
    print("attention with keyless rows (4,8,267,267,64) causal band 20, k_len "
          f"[267,100,30,1]: K1 f32 max_abs={errs[0]:.3e} bf16 max_abs={errs[1]:.3e}, "
          "K2 refuses")


def check_attention_bwd(dev) -> dict:
    """K2 through the autograd Function (K1 forward saving the row
    log-sum-exp, K2 backward) vs the plain backward on the same inputs."""
    worst, timed = 0.0, {}
    for i, case in enumerate(ATTENTION_CASES):
        name, b, tq, tk, causal, band, rate, d = case
        q, k, v, q_len, k_len, scale = _attn_case(i, case, dev, 10)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to(dev)
        args = (q_len, k_len, 777, scale, rate, causal, band)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            leaves = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
            out = fa.fused_attention_general(*leaves, *args)
            out.backward(g.to(dtype))
            want = fa.attention_backward_reference(
                *(x.detach().float() for x in leaves), *args, g.to(dtype).float()
            )
            torch.cuda.synchronize()
            got = [x.grad for x in leaves]
            require(all(x.dtype == dtype and bool(torch.isfinite(x).all()) for x in got),
                    f"attention bwd {name}: dtype or non-finite")
            errs[dtype] = max((a.float() - w).abs().max().item() for a, w in zip(got, want))
        shape = [b, HEADS, tq, tk, d]
        print(f"attention bwd {name} {shape}: f32 max_abs="
              f"{errs[torch.float32]:.3e} bf16 max_abs={errs[torch.bfloat16]:.3e}")
        require(errs[torch.float32] <= 1e-4, f"attention bwd {name} f32 disagrees")
        require(errs[torch.bfloat16] <= 2e-2, f"attention bwd {name} bf16 disagrees")
        worst = max(worst, errs[torch.bfloat16])
        if name in TIMED_ATTENTION:
            qb, kb, vb, gb = (x.to(torch.bfloat16) for x in (q, k, v, g))
            lse = torch.empty(qb.shape[:3], dtype=torch.float32, device=dev)
            out = fa._launch(qb, kb, vb, q_len, k_len, 777, scale, rate, causal, band, lse)
            mask = _sdpa_mask(q_len, k_len, tq, tk, causal, band)
            lib_fwd, lib_both = _sdpa_library(qb, kb, vb, mask, scale, gb)
            times = turns_ms({
                "kernel": lambda: fa.attention_backward_kernel(
                    qb, kb, vb, out, lse, *args, gb),
                "library forward": lib_fwd,
                "library forward+backward": lib_both,
                "plain": lambda: fa.attention_backward_reference(qb, kb, vb, *args, gb),
            })
            times["library"] = times["library forward+backward"] - times["library forward"]
            device = turns_ms({
                "fma": _attention_bwd_entry(
                    "asr_attention_bwd_fma", qb, kb, vb, out, lse, *args, gb),
                "kernel": _attention_bwd_entry(
                    "asr_attention_bwd", qb, kb, vb, out, lse, *args, gb),
            }, n=5, reps=DEVICE_REPS)
            limits = attention_bwd_bound(b, HEADS, tq, tk, d)
            _print_times(f"attention bwd {name} bf16 (library: SDPA forward+backward "
                         f"minus forward, dropout 0)", shape, times, limits)
            timed[name] = {**_measured(shape, errs[torch.bfloat16], times, limits),
                           **_device_times(f"attention bwd {name}", shape, device, limits)}
    _check_keyless_rows(dev)
    first, *others = (timed[n] for n in TIMED_ATTENTION)
    return {**first, "max_abs_err": worst, "other_shapes": others}


# -- phase 6: windowed causal-band attention (K6 / K7) --------------------------

# (name, batch, T, band, rate, lengths or None for the training rows): the
# streaming model's training and serving encoder shapes, a ragged case, and
# the bands at either side of BQ = 64
BANDED_CASES = [
    ("train-band50", 64, 267, 50, 0.0, None),
    ("train-band50-dropout0.1", 64, 267, 50, 0.1, None),
    ("serve-501", 1, 501, 50, 0.0, [501]),
    ("ragged-band30", 2, 150, 30, 0.0, [150, 97]),
    ("band64-501", 2, 501, 64, 0.0, [501, 388]),
    ("band65-501", 2, 501, 65, 0.0, [501, 388]),
]


def _banded_inputs(b, t, lengths, dev, seed):
    q, k, v, q_len, _ = _attn_inputs(b, 8, t, t, 64, dev, seed)
    if lengths is not None:
        q_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, q_len


def check_banded(dev) -> tuple[dict, dict]:
    """K6 and K7 through the autograd Function with the window on (which
    must route to them) vs their plain versions; K6 vs K1; times at the
    training shape."""
    scale = 1.0 / 8.0
    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, (name, b, t, band, rate, lengths) in enumerate(BANDED_CASES):
        q, k, v, n = _banded_inputs(b, t, lengths, dev, seed=20 + i)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to(dev)
        args = (n, n, 4321, scale, rate, True, band)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            leaves = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
            before = fa.banded_attention_kernel.launches, fa.fused_attention_general.launches
            with banded_window("1"):
                out = fa.fused_attention_general(*leaves, *args)
                out.backward(g.to(dtype))
            require((fa.banded_attention_kernel.launches - before[0],
                     fa.fused_attention_general.launches - before[1]) == (1, 0),
                    f"banded {name}: the window did not route to K6")
            plain = [x.detach().float() for x in leaves]
            want = fa.banded_attention_reference(*plain, n, 4321, scale, rate, band)
            want_g = fa.banded_attention_backward_reference(
                *plain, n, 4321, scale, rate, band, g.to(dtype).float())
            torch.cuda.synchronize()
            require(out.dtype == dtype and all(x.grad.dtype == dtype for x in leaves),
                    f"banded {name}: dtype")
            pairs = [(out, want)] + [(x.grad, w) for x, w in zip(leaves, want_g)]
            errs[dtype] = [(got.float() - w).abs().max().item() for got, w in pairs]
            largest = max(w.abs().max().item() for _, w in pairs[1:])
        e32, e16 = errs[torch.float32], errs[torch.bfloat16]
        print(f"banded {name} ({b},8,{t},64) band {band} rate {rate}: fwd f32 max_abs="
              f"{e32[0]:.3e} bf16 {e16[0]:.3e}; bwd (dq, dk, dv) f32 "
              f"{', '.join(f'{e:.3e}' for e in e32[1:])} bf16 "
              f"{', '.join(f'{e:.3e}' for e in e16[1:])} (largest |grad| {largest:.3f})")
        require(max(e32) <= 1e-4, f"banded {name} f32 disagrees")
        require(max(e16) <= 2e-2, f"banded {name} bf16 disagrees")
        worst["fwd"] = max(worst["fwd"], e16[0])
        worst["bwd"] = max(worst["bwd"], *e16[1:])

    # K6 and K1 interchangeable mid-training: the same weights dropped
    q, k, v, n = _banded_inputs(64, 267, None, dev, seed=30)
    k6 = fa.banded_attention_kernel(q, k, v, n, 99, scale, 0.1, 50)
    k1 = fa._launch(q, k, v, n, n, 99, scale, 0.1, True, 50)
    torch.cuda.synchronize()
    k6_k1 = (k6 - k1).abs().max().item()
    print(f"banded K6 vs K1, f32 (64,8,267,64) band 50 dropout 0.1: max_abs={k6_k1:.3e}")
    require(k6_k1 <= 1e-5, "K6 and K1 disagree")

    # times at the streaming training shape, bf16, hash dropout 0.1
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    gb = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(dev, torch.bfloat16)
    lse6 = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    lse1 = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    fa.banded_attention_kernel(qb, kb, vb, n, 7, scale, 0.1, 50, lse6)
    out1 = fa._launch(qb, kb, vb, n, n, 7, scale, 0.1, True, 50, lse1)
    mask = _sdpa_mask(n, n, 267, 267, True, 50)
    lib_fwd, lib_both = _sdpa_library(qb, kb, vb, mask, scale, gb)
    with torch.no_grad():
        fwd = turns_ms({
            "kernel": lambda: fa.banded_attention_kernel(qb, kb, vb, n, 7, scale, 0.1, 50),
            "K1 (causal band 50)": lambda: fa._launch(
                qb, kb, vb, n, n, 7, scale, 0.1, True, 50),
            "library": lib_fwd,
            "plain": lambda: fa.banded_attention_reference(qb, kb, vb, n, 7, scale, 0.1, 50),
        })
    bwd = turns_ms({
        "kernel": lambda: fa.banded_attention_backward_kernel(
            qb, kb, vb, lse6, n, 7, scale, 0.1, 50, gb),
        "K2 (causal band 50)": lambda: fa.attention_backward_kernel(
            qb, kb, vb, out1, lse1, n, n, 7, scale, 0.1, True, 50, gb),
        "library forward": lib_fwd,
        "library forward+backward": lib_both,
        "plain": lambda: fa.banded_attention_backward_reference(
            qb, kb, vb, n, 7, scale, 0.1, 50, gb),
    })
    bwd["library"] = bwd["library forward+backward"] - bwd["library forward"]
    shape = [64, HEADS, 267, 267, 64]
    pairs = band_pairs(n.tolist(), HEADS, 50)
    limits = (attention_fwd_bound(64, HEADS, 267, 267, 64, pairs=pairs),
              banded_attention_bwd_bound(64, HEADS, 267, 64, pairs=pairs))
    what = "bf16 band 50 dropout 0.1 (library: SDPA with the causal-band mask, dropout 0)"
    _print_times(f"banded K6 {what}", shape, fwd, limits[0])
    _print_times(f"banded K7 {what}", shape, bwd, limits[1])
    return (_measured(shape, worst["fwd"], fwd, limits[0]),
            _measured(shape, worst["bwd"], bwd, limits[1]))


# -- phase 7: CTC alpha / beta -------------------------------------------------


def _ctc_inputs(dev, dtype, b=64, t=267, c=4233, label_pad=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(b, t, c, generator=g) * 2.0).to(dtype)
    lens = torch.tensor([t - (i * 7) % 120 for i in range(b)], dtype=torch.int32)
    lab_lens = torch.tensor([1 + (i * 5) % label_pad for i in range(b)], dtype=torch.int32)
    labels = torch.randint(1, c, (b, label_pad), generator=g, dtype=torch.int32)
    labels = labels * (torch.arange(label_pad)[None, :] < lab_lens[:, None])
    return [x.to(dev) for x in (logits, lens, labels, lab_lens)]


def check_ctc(dev) -> tuple[dict, dict]:
    """K3 and K4 vs their plain versions (and the loss vs F.ctc_loss) at the
    flagship's CTC shapes, (64, 267, 4233), ragged lengths, label pad 32."""
    worst = {"alpha": 0.0, "beta": 0.0}
    timing = {}
    for dtype in (torch.float32, torch.bfloat16):
        logits, lens, labels, lab_lens = _ctc_inputs(dev, dtype)
        x = logits.clone().requires_grad_(True)
        loss = ctc.ctc_loss_kernel(x, lens, labels, lab_lens)
        g = torch.linspace(0.5, 1.5, loss.shape[0], device=dev)
        loss.backward(g)
        ext = ctc_ops.extend_labels(labels.long())
        want_loss, alpha, lse = ctc.ctc_alpha_reference(logits, ext, lens, lab_lens)
        want_grad = ctc.ctc_beta_reference(
            logits, ext, lens, lab_lens, lse, alpha, want_loss, g)
        oracle = F.ctc_loss(
            torch.log_softmax(logits.float(), -1).transpose(0, 1), labels.long(),
            lens.long(), lab_lens.long(), blank=0, reduction="none",
            zero_infinity=False,
        )
        torch.cuda.synchronize()
        rel = ((loss - want_loss).abs() / want_loss.abs()).max().item()
        rel_oracle = ((loss - oracle).abs() / oracle.abs()).max().item()
        g_err = (x.grad.float() - want_grad.float()).abs().max().item()
        name = str(dtype).replace("torch.", "")
        print(f"ctc {name} (64,267,4233) label pad 32: loss max_rel={rel:.3e} "
              f"(F.ctc_loss {rel_oracle:.3e}) d_logits max_abs={g_err:.3e}")
        require(x.grad.dtype == dtype, f"ctc {name}: gradient dtype {x.grad.dtype}")
        require(rel <= 1e-4 and rel_oracle <= 1e-4, f"ctc {name} loss disagrees")
        # f32: 1e-3; bf16: the gradient is rounded to bf16 on both sides
        require(g_err <= (1e-3 if dtype == torch.float32 else 1e-2),
                f"ctc {name} gradient disagrees")
        worst["alpha"] = max(worst["alpha"], (loss - want_loss).abs().max().item())
        worst["beta"] = max(worst["beta"], g_err)
        if dtype == torch.bfloat16:
            ext_i, lens_i, lab_i = ctc._check_kernel_inputs(logits, ext, lens, lab_lens)
            k_loss, k_alpha, k_lse = ctc.ctc_alpha_kernel(logits, ext_i, lens_i, lab_i)
            leaf = logits.detach().clone().requires_grad_(True)
            targets, in_lens, tgt_lens = labels.long(), lens.long(), lab_lens.long()

            def lib_fwd():
                # the library's pair for the same function: log-softmax, then
                # the alpha recursion (its backward: beta and the gradient)
                logp = F.log_softmax(leaf, -1, dtype=torch.float32).transpose(0, 1)
                return F.ctc_loss(logp, targets, in_lens, tgt_lens, blank=0,
                                  reduction="none", zero_infinity=False)

            timing["alpha"] = turns_ms({
                "kernel": lambda: ctc.ctc_alpha_kernel(logits, ext_i, lens_i, lab_i),
                "library": lib_fwd,
            })
            timing["beta"] = turns_ms({
                "kernel": lambda: ctc.ctc_beta_kernel(
                    logits, ext_i, lens_i, lab_i, k_lse, k_alpha, k_loss, g),
                "library forward": lib_fwd,
                "library forward+backward": lambda: torch.autograd.grad(lib_fwd(), leaf, g),
            })
            timing["beta"]["library"] = (timing["beta"]["library forward+backward"]
                                         - timing["beta"]["library forward"])
            timing["alpha"]["plain"] = median_ms(
                lambda: ctc.ctc_alpha_reference(logits, ext, lens, lab_lens), n=5, warmup=1)
            timing["beta"]["plain"] = median_ms(
                lambda: ctc.ctc_beta_reference(
                    logits, ext, lens, lab_lens, lse, alpha, want_loss, g), n=5, warmup=1)
            shape = list(logits.shape)
            dims = (*shape, ext.shape[1])
            limits = {"alpha": ctc_alpha_bound(*dims), "beta": ctc_beta_bound(*dims)}
            for part in ("alpha", "beta"):
                _print_times(f"ctc {part} bf16 (library: F.log_softmax + F.ctc_loss; plain: "
                             f"median of 5)", shape, timing[part], limits[part])
    return tuple(_measured(shape, worst[p], timing[p], limits[p]) for p in ("alpha", "beta"))


# -- phase 8: the serving path -------------------------------------------------


def flagship_config(dtype: str) -> Config:
    feat = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, attn_impl="fused", fbank_impl="pallas",
        input_dim=feat.feature_dim,
    )
    return Config(**cfg.to_dict())


def check_encoder_against_cpu(corpus, vocab_size, dev) -> float:
    """f32 encoder through the kernels on the card vs the plain path on the
    CPU, two utterances of the corpus."""
    cfg = flagship_config("float32")
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0)).eval()
    recs = read_manifest(corpus["test"])[:2]
    waves = [load_wav(r["wave"], dtype=np.int16) for r in recs]
    s = max(len(w) for w in waves)
    pcm = np.zeros((2, s), np.int16)
    for i, w in enumerate(waves):
        pcm[i, : len(w)] = w
    lens = torch.tensor([len(w) for w in waves], dtype=torch.int32)
    feat_cfg = FeatureConfig(fbank_impl="pallas")
    with torch.inference_mode():
        f_cpu, fl_cpu = parse_batch(torch.from_numpy(pcm), lens, feat_cfg)
        want, _ = model.encode(f_cpu, fl_cpu)
        model_d = model.to(dev)
        f_d, fl_d = parse_batch(torch.from_numpy(pcm).to(dev), lens.to(dev), feat_cfg)
        got, _ = model_d.encode(f_d, fl_d)
    torch.cuda.synchronize()
    return (got.cpu() - want).abs().max().item()


def run_serving_path(dev) -> dict:
    shutil.rmtree(WORK, ignore_errors=True)
    corpus = make_synth_corpus(
        os.path.join(WORK, "corpus"), n_train=0, n_dev=0, n_test=16,
        n_tone_chars=40, vocab_size=4233, seconds_range=(2.0, 8.0), seed=0,
    )
    vocab = Vocab.load(corpus["vocab"])
    require(vocab.vocab_size == 4233, f"vocab size {vocab.vocab_size}")
    exp = os.path.join(WORK, "exp")
    os.makedirs(exp)
    cfg = flagship_config("bfloat16")
    cfg.save(os.path.join(exp, "config.json"))
    model = SpeechTransformer(cfg, vocab.vocab_size, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    save_torch_checkpoint(exp, model.state_dict(), vocab.fingerprint(), "best")
    print(f"flagship: d_model 512, 8 heads, 6+6 layers, bf16, vocab 4233, "
          f"{n_params} parameters")

    enc_err = check_encoder_against_cpu(corpus, vocab.vocab_size, dev)
    print(f"encoder f32 kernels-on-card vs plain-on-cpu: max_abs={enc_err:.3e}")
    require(enc_err <= 1e-3, "encoder output disagrees with the CPU run")

    reset_counters()
    t0 = time.perf_counter()
    res = recognize(
        exp, corpus["vocab"], manifest=corpus["test"], mode="beam", beam_size=10,
        batch_size=8, max_decode_len=64, device="cuda",
        out=os.path.join(WORK, "results.json"),
    )
    wall = time.perf_counter() - t0
    counts = read_counters()
    launches = {"fbank": counts["fbank"], "attention": counts["fused_attention_fwd"]}

    records = read_manifest(corpus["test"])
    utts = res["utts"]
    require(len(records) == 16 and len(utts) == 16, f"{len(utts)} of 16 decoded")
    for utt, entry in utts.items():
        outs = entry["output"]
        require(len(outs) >= 1, f"{utt}: no hypothesis")
        require(all(np.isfinite(o["score"]) for o in outs), f"{utt}: score not finite")
    tm = res["timing"]
    n = tm["batches"]
    require(launches["fbank"] == n, f"fbank launches {launches['fbank']} != {n} batches")
    require(launches["attention"] == 6 * n,
            f"attention launches {launches['attention']} != 6 x {n} batches")
    print(f"recognize: {len(utts)} utterances, {n} batches, {tm['audio_s']:.3f} s audio, "
          f"CER {res['cer']:.2f}% (random weights)")
    print(f"recognize per batch: encode {tm['encode_s'] / n * 1e3:.3f} ms, "
          f"search {tm['search_s'] / n * 1e3:.3f} ms; wall {wall:.3f} s incl. model "
          f"load; audio-s/s {tm['audio_s'] / (tm['encode_s'] + tm['search_s']):.3f} "
          f"(encode+search), {tm['audio_s'] / wall:.3f} (wall)")
    print(f"launches in the recognize run: {counts}")
    return counts, n


# -- phase 9: the training path ------------------------------------------------


def training_kwargs(corpus, exp_root, **extra) -> dict:
    """``main.train`` kwargs for the flagship recipe of ``bench.py::main``."""
    kw = dict(
        vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest=None,
        model_name="TransformerOffical", ctc_weight=0.3, dtype="bfloat16",
        attn_impl="fused", fbank_impl="pallas", dropout_impl="hash",
        ctc_impl="pallas", spec_augment=True, batch_size=64, num_epoch=2,
        log_every_iter=1, eval_every_iter=0, save_every_iter=0, device="cuda",
        use_native_io=False, exp_root=exp_root, exp_name="flagship", seed=0,
    )
    kw.update(extra)
    return kw


def _logged_losses(exp_dir):
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "train/loss" in r]


def run_training_path(dev):
    corpus = make_synth_corpus(
        os.path.join(WORK, "train_corpus"), n_train=128, n_dev=16, n_test=0,
        n_tone_chars=40, vocab_size=VOCAB, seconds_range=(7.5, 8.0), seed=1,
    )
    exp_root = os.path.join(WORK, "train_exp")
    shutil.rmtree(exp_root, ignore_errors=True)
    reset_counters()
    t0 = time.perf_counter()
    trainer = main_train(**training_kwargs(corpus, exp_root))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    steps = trainer.state.step
    n_eval = 2 * len(trainer.dev_loader)  # one dev pass per epoch
    print(f"train: {steps} steps in 2 epochs, {n_eval} dev batches, wall {wall:.3f} s "
          f"(incl. model build, evals, checkpoints); launches {counts}")
    require(steps == 4, f"train ran {steps} steps, want 4 (2 epochs x 2 batches)")
    want = {k: 0 for k in COUNTERS}
    want.update({
        "fbank": steps + n_eval, "fused_attention_fwd": 6 * (steps + n_eval),
        "fused_attention_bwd": 6 * steps, "ctc_alpha": steps + n_eval,
        "ctc_beta": steps,
    })
    require(counts == want, f"training launches {counts} != {want}")
    rows = _logged_losses(trainer.exp_dir)
    require(len(rows) == steps, f"{len(rows)} logged train rows")
    require(all(np.isfinite(r["train/loss"]) for r in rows), "non-finite train loss")
    for r in rows:
        print(f"train step {r['step']}: loss {r['train/loss']:.4f} ctc "
              f"{r['train/ctc_loss']:.4f} ce {r['train/ce_loss']:.4f} grad_norm "
              f"{r['train/grad_norm']:.4f} lr {r['lr']:.3e}")
    index_path = os.path.join(trainer.exp_dir, "checkpoints", "index.json")
    with open(index_path) as f:
        index = json.load(f)
    require(index["latest"] == "e2_s4", f"index latest {index['latest']}")
    exp_dir = trainer.exp_dir
    del trainer
    torch.cuda.empty_cache()

    resumed = main_train(**training_kwargs(corpus, exp_root, from_ckpt="latest",
                                           num_epoch=3))
    torch.cuda.synchronize()
    new_steps = [r["step"] for r in _logged_losses(exp_dir)][steps:]
    print(f"resume: from e2_s4 to step {resumed.state.step}, logged steps {new_steps}")
    require(resumed.state.step == 6 and new_steps == [5, 6], "resume did not continue")
    require(resumed.optimizer.count == 6, "optimizer count not restored")
    del resumed
    torch.cuda.empty_cache()

    res = recognize(
        exp_dir, corpus["vocab"], manifest=corpus["dev"], mode="beam", beam_size=10,
        batch_size=8, max_decode_len=32, device="cuda",
        out=os.path.join(WORK, "train_decode.json"),
    )
    require(len(res["utts"]) == 16, f"{len(res['utts'])} of 16 dev utterances decoded")
    for utt, entry in res["utts"].items():
        require(entry["output"] and all(np.isfinite(o["score"]) for o in entry["output"]),
                f"{utt}: no finite hypothesis")
    print(f"best checkpoint decodes the dev set on the card: CER {res['cer']:.2f}% "
          f"after 6 steps")
    return counts, corpus


# -- phase 10: one f32 step, card vs CPU ----------------------------------------


def _recipe(dtype: str, **overrides) -> tuple:
    """(model config, train config, feature config) of the flagship recipe."""
    cfg = flagship_config(dtype).build(dropout_impl="hash", ctc_impl="pallas", **overrides)
    return cfg, default_train_config().combine(cfg), FeatureConfig(fbank_impl="pallas")


def _one_step(cfg, tcfg, feat, batch, device):
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(device)
    opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    state, m = train_step(init_fn(), *(x.to(device) for x in batch), 0)
    return float(m["loss"]), float(m["grad_norm"])


def check_step_against_cpu(corpus, dev) -> None:
    cfg, tcfg, feat = _recipe("float32", dropout_rate=0.0)
    tcfg.build(spec_augment=False)
    recs = read_manifest(corpus["train"])[:2]
    waves = [load_wav(r["wave"], dtype=np.int16) for r in recs]
    pcm = np.zeros((2, 128000), np.int16)
    for i, w in enumerate(waves):
        pcm[i, : len(w)] = w
    vocab = Vocab.load(corpus["vocab"])
    ids = [vocab.str_to_ids(r["tgt"]) for r in recs]
    labels = np.zeros((2, 31), np.int32)
    for i, x in enumerate(ids):
        labels[i, : len(x)] = x
    batch = (
        torch.from_numpy(pcm), torch.tensor([len(w) for w in waves], dtype=torch.int32),
        torch.from_numpy(labels), torch.tensor([len(x) for x in ids], dtype=torch.int32),
    )
    cpu = _one_step(cfg, tcfg, feat, batch, torch.device("cpu"))
    card = _one_step(cfg, tcfg, feat, batch, dev)
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"f32 step, card vs cpu: loss {card[0]:.6f} vs {cpu[0]:.6f} (rel {rel[0]:.2e}), "
          f"grad_norm {card[1]:.6f} vs {cpu[1]:.6f} (rel {rel[1]:.2e})")
    require(max(rel) <= 1e-3, "f32 train step on the card disagrees with the CPU")


# -- phase 11: streaming training ----------------------------------------------

# the streaming recipe of artifacts/r5_streaming/config.json (its corpus
# paths, joint evaluation and the JAX-only keys left out)
STREAMING_RECIPE = dict(
    model_name="TransformerOffical", norm_type="pre", causal_encoder=True,
    attention_band=50, cmvn_mode="fixed", cmvn_mean=-24.004314, cmvn_std=2.375894,
    dropout_rate=0.0, ctc_weight=0.3, dtype="bfloat16", attn_impl="fused",
    decoder_attn_impl="xla", fbank_impl="pallas", ctc_impl="pallas",
    lr_schedule="noam", noam_factor=0.25, warmup=150, spec_augment=False,
    eval_decode="none",
)


def run_streaming_training(corpus) -> tuple[dict, str]:
    """``main.train`` with the streaming recipe through K6/K7; returns the
    launch counts and the experiment directory."""
    exp_root = os.path.join(WORK, "stream_exp")
    shutil.rmtree(exp_root, ignore_errors=True)
    kw = dict(
        STREAMING_RECIPE, vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest=None, batch_size=64, num_epoch=2,
        log_every_iter=1, eval_every_iter=0, save_every_iter=0, device="cuda",
        use_native_io=False, exp_root=exp_root, exp_name="streaming", seed=0,
    )
    with banded_window("1"):
        reset_counters()
        t0 = time.perf_counter()
        trainer = main_train(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
    steps = trainer.state.step
    n_eval = 2 * len(trainer.dev_loader)
    print(f"streaming train: {steps} steps in 2 epochs, {n_eval} dev batches, wall "
          f"{wall:.3f} s; launches {counts}")
    require(steps == 4, f"streaming train ran {steps} steps, want 4")
    want = {
        "fbank": steps + n_eval, "fused_attention_fwd": 0, "fused_attention_bwd": 0,
        "banded_attention_fwd": 6 * (steps + n_eval), "banded_attention_bwd": 6 * steps,
        "ctc_alpha": steps + n_eval, "ctc_beta": steps,
    }
    require(counts == want, f"streaming training launches {counts} != {want}")
    rows = _logged_losses(trainer.exp_dir)
    require(len(rows) == steps and all(np.isfinite(r["train/loss"]) for r in rows),
            "streaming train: missing or non-finite losses")
    for r in rows:
        print(f"streaming train step {r['step']}: loss {r['train/loss']:.4f} ctc "
              f"{r['train/ctc_loss']:.4f} ce {r['train/ce_loss']:.4f} grad_norm "
              f"{r['train/grad_norm']:.4f} lr {r['lr']:.3e}")
    exp_dir = trainer.exp_dir
    require(os.path.exists(checkpoint_path(exp_dir, "best")), "no best checkpoint")
    del trainer
    torch.cuda.empty_cache()
    return counts, exp_dir


# -- phase 12: streaming serving -----------------------------------------------

STREAM_CHUNK = 2000  # samples (125 ms)


def make_streams(n_streams=4, per_stream=3) -> list:
    """int16 streams of synthetic 2-4 s utterances, each padded to whole
    chunks and followed by 1 s of zeros (so the energy gate's 1 s
    hangover closes each utterance)."""
    corpus = make_synth_corpus(
        os.path.join(WORK, "stream_corpus"), n_train=0, n_dev=0,
        n_test=n_streams * per_stream, n_tone_chars=40, vocab_size=VOCAB,
        seconds_range=(2.0, 4.0), seed=2,
    )
    waves = [load_wav(r["wave"], dtype=np.int16) for r in read_manifest(corpus["test"])]
    streams = []
    for s in range(n_streams):
        parts = []
        for w in waves[s * per_stream : (s + 1) * per_stream]:
            pad = -len(w) % STREAM_CHUNK
            parts += [w, np.zeros(pad + 16000, np.int16)]
        streams.append(np.concatenate(parts))
    return streams


def _pct(xs, p) -> float:
    return float(np.percentile(xs, p)) if xs else float("nan")


def serve_streams(rec, streams):
    """Feed every stream in 2000-sample chunks (``reset_stream`` between
    streams); returns (finals [(text, t0, t1)], partial ms, final ms,
    incremental segments [(samples, accumulated encoder output)])."""
    finals, t_partial, t_final, inc_segments = [], [], [], []
    if rec.incremental:  # keep each final's accumulated encoder output
        inner = rec._inc_final_text

        def keep_segment(start, seg):
            text = inner(start, seg)
            inc_segments.append((seg, torch.cat(rec._inc_enc)))
            return text

        rec._inc_final_text = keep_segment
    for x in streams:
        rec.reset_stream()
        chunks = [x[i : i + STREAM_CHUNK] for i in range(0, len(x), STREAM_CHUNK)]
        for c in chunks + [None]:
            t0 = time.perf_counter()
            events = rec.feed(c) if c is not None else rec.finish()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kinds = {e.kind for e in events}
            if "final" in kinds:
                t_final.append(ms)
            elif "partial" in kinds:
                t_partial.append(ms)
            finals += [(e.text, e.t0, e.t1) for e in events if e.kind == "final"]
    return finals, t_partial, t_final, inc_segments


def run_streaming_serving(exp_dir: str, vocab_path: str, dev) -> dict:
    """The streaming checkpoint served in both encode modes and both final
    modes, bf16 and f32; returns the launch counts of the bf16 prefix
    re-encode runs."""
    model, cfg, feat_cfg, vocab = load_experiment(exp_dir, vocab_path, "best", device=dev)
    blob = torch.load(checkpoint_path(exp_dir, "best"), map_location="cpu",
                      weights_only=True)
    model32 = SpeechTransformer(Config(**{**cfg.to_dict(), "dtype": "float32"}),
                                vocab.vocab_size)
    model32.load_state_dict(blob["state_dict"])
    model32 = model32.to(dev).eval()
    streams = make_streams()
    print(f"streaming serving: {len(streams)} streams of "
          f"{', '.join(f'{len(x) / 16000:.3f}' for x in streams)} s")
    launches = {k: 0 for k in COUNTERS}
    finals = {}
    for dtype, m in (("bfloat16", model), ("float32", model32)):
        for mode in ("ctc_greedy", "beam"):
            for inc in ("off", "on"):
                rec = StreamingRecognizer(m, vocab, feat_cfg, mode=mode, beam_size=10,
                                          partial_every_s=1.0, incremental=inc)
                require(rec.incremental == (inc == "on"), "incremental mode not taken")
                n_encodes = [0]
                encode = rec._run_encode

                def counted(samples, _encode=encode, _n=n_encodes):
                    _n[0] += 1
                    return _encode(samples)

                rec._run_encode = counted
                with banded_window("1"):
                    reset_counters()
                    out, t_p, t_f, segs = serve_streams(rec, streams)
                    counts = read_counters()
                n = n_encodes[0]
                if inc == "off":
                    want = {k: 0 for k in COUNTERS}
                    want.update(fbank=n, banded_attention_fwd=6 * n)
                    if dtype == "bfloat16":
                        launches = {k: launches[k] + counts[k] for k in COUNTERS}
                else:
                    want = {k: 0 for k in COUNTERS}
                    require(n == 0, "the incremental path re-encoded a prefix")
                require(counts == want, f"stream {dtype} {mode} {inc}: launches "
                        f"{counts} != {want}")
                finals[dtype, mode, inc] = out
                label = "incremental" if inc == "on" else "prefix re-encode"
                print(f"stream {dtype} {mode} {label}: {len(out)} finals, {n} encodes; "
                      f"partial ms median {_pct(t_p, 50):.3f} p90 {_pct(t_p, 90):.3f} "
                      f"(n={len(t_p)}); final ms median {_pct(t_f, 50):.3f} p90 "
                      f"{_pct(t_f, 90):.3f} (n={len(t_f)})")
                if dtype == "float32" and inc == "on":
                    err = 0.0
                    for seg, enc_inc in segs:
                        enc, enc_lens, _ = rec._run_encode(seg)
                        t_valid = int(enc_lens[0])
                        require(enc_inc.shape[0] == t_valid, "incremental frame count")
                        err = max(err, (enc_inc - enc[0, :t_valid]).abs().max().item())
                    print(f"stream f32 {mode}: accumulated incremental encoder output vs "
                          f"offline encode of the bucketed segment, {len(segs)} segments: "
                          f"max_abs={err:.3e}")
                    require(err <= 1e-3, "incremental encoder output disagrees")
    for dtype in ("bfloat16", "float32"):
        for mode in ("ctc_greedy", "beam"):
            a, b = finals[dtype, mode, "on"], finals[dtype, mode, "off"]
            require([x[1:] for x in a] == [x[1:] for x in b], "final segment bounds differ")
            same = sum(x[0] == y[0] for x, y in zip(a, b))
            print(f"stream {dtype} {mode}: {same} of {len(a)} incremental finals equal "
                  f"the prefix re-encode finals; first: {a[0][0][:40]!r}")
            if dtype == "float32":
                require(same == len(a), f"f32 {mode}: incremental finals differ")
    require(len(finals["bfloat16", "beam", "off"]) == 3 * len(streams),
            "want 3 finals per stream")
    return launches


# -- phase 13: throughput ------------------------------------------------------


def analytic_train_flops(cfg, feat_cfg, vocab_size: int, batch: int,
                         n_samples: int, label_len: int) -> float:
    """Matmul FLOPs of one train step (fwd + bwd = 3x fwd): a copy of the
    JAX package's ``bench.py::analytic_train_flops`` (projections,
    attention products, FFNs, vocabulary heads, the DFT-as-matmul fbank;
    elementwise work excluded, as MFU accounting does)."""
    d, ff = cfg.d_model, cfg.d_ff
    le, ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    t_frames = feat_cfg.num_frames(n_samples)
    t = feat_cfg.num_lfr_frames(t_frames)
    l = label_len + 1  # decoder is BOS-prefixed
    v = vocab_size
    n_bins = feat_cfg.n_fft // 2 + 1
    fwd = t_frames * feat_cfg.win_length * (2 * n_bins) * 2
    fwd += t_frames * n_bins * feat_cfg.n_mels * 2
    fwd += t * feat_cfg.feature_dim * d * 2
    fwd += le * (4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * ff * 2)
    if float(cfg.get("ctc_weight", 0.0)) > 0:
        fwd += t * d * v * 2
    fwd += ld * (4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2
                 + 2 * t * d * d * 2 + 2 * l * t * d * 2 + 2 * l * d * ff * 2)
    fwd += l * d * v * 2
    return 3.0 * fwd * batch


THROUGHPUT_BATCH, THROUGHPUT_SECONDS, THROUGHPUT_LABEL_LEN = 64, 8.0, 20


def flagship_train_setup(dev) -> tuple:
    """(train_step, state, batch, flops per step) of the flagship recipe
    (bf16, hash dropout 0.1, SpecAugment, CTC 0.3 through the kernels) on
    one fixed batch of 64 x 8 s with label length 20, as ``bench.py``."""
    cfg, tcfg, feat = _recipe("bfloat16")
    tcfg.build(spec_augment=True)
    bsz, label_len = THROUGHPUT_BATCH, THROUGHPUT_LABEL_LEN
    samples = int(THROUGHPUT_SECONDS * feat.sample_rate)
    rng = np.random.RandomState(0)
    batch = [
        torch.from_numpy((rng.randn(bsz, samples) * 0.1 * 32767).astype(np.int16)),
        torch.full((bsz,), samples, dtype=torch.int32),
        torch.from_numpy(rng.randint(4, VOCAB, size=(bsz, label_len)).astype(np.int32)),
        torch.full((bsz,), label_len, dtype=torch.int32),
    ]
    batch = [x.to(dev) for x in batch]
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    flops = analytic_train_flops(cfg, feat, VOCAB, bsz, samples, label_len)
    return train_step, init_fn(), batch, flops


def measure_training_throughput(dev, n_warmup=3, n_timed=20) -> dict:
    train_step, state, batch, flops = flagship_train_setup(dev)
    bsz, seconds = THROUGHPUT_BATCH, THROUGHPUT_SECONDS
    for _ in range(n_warmup):
        state, m = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, m = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_timed
    counts = read_counters()
    require(np.isfinite(float(m["loss"])), "throughput loop loss not finite")
    require(counts["fused_attention_bwd"] == 6 * n_timed and counts["ctc_beta"] == n_timed,
            f"throughput loop launches {counts}")
    out = {
        "launches_per_step": {k: v / n_timed for k, v in counts.items()},
        "ms_per_step": step_s * 1e3,
        "steps_per_s": 1.0 / step_s,
        "audio_s_per_s": bsz * seconds / step_s,
        "tflop_per_step": flops / 1e12,
        "mfu": flops / step_s / H100_SXM_BF16_PEAK,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"train throughput, flagship bf16, batch 64 x 8 s, {n_timed} steps after "
          f"{n_warmup} warm-up: {out['ms_per_step']:.3f} ms/step, "
          f"{out['steps_per_s']:.4f} steps/s, {out['audio_s_per_s']:.1f} audio-s/s, "
          f"{out['tflop_per_step']:.4f} TFLOP/step, MFU {out['mfu'] * 100:.3f} % of "
          f"{H100_SXM_BF16_PEAK / 1e12:.1f} TFLOP/s, peak memory "
          f"{out['peak_mem_gib']:.2f} GiB, final loss {float(m['loss']):.4f}")
    return out


# -- phase 14: streaming throughput, windowed vs full-tile ---------------------


def streaming_train_setup(dev) -> tuple:
    """(train_step, state, batch) of the streaming recipe (bf16, dropout 0,
    no SpecAugment, CTC 0.3 through the kernels) on one fixed batch of 64
    x 8 s with label length 20. The attention route is read at each call:
    set ``ASR_BANDED_WINDOW`` around the steps."""
    recipe = {k: v for k, v in STREAMING_RECIPE.items()
              if k not in ("model_name", "cmvn_mode", "cmvn_mean", "cmvn_std",
                           "lr_schedule", "noam_factor", "warmup", "spec_augment",
                           "eval_decode")}
    cfg = flagship_config("bfloat16").build(**recipe)
    tcfg = default_train_config().combine(cfg).build(
        lr_schedule="noam", noam_factor=0.25, warmup=150, spec_augment=False)
    feat = FeatureConfig(fbank_impl="pallas", cmvn_mode="fixed",
                         cmvn_mean=STREAMING_RECIPE["cmvn_mean"],
                         cmvn_std=STREAMING_RECIPE["cmvn_std"])
    bsz, samples = THROUGHPUT_BATCH, int(THROUGHPUT_SECONDS * 16000)
    rng = np.random.RandomState(0)
    batch = [
        torch.from_numpy((rng.randn(bsz, samples) * 0.1 * 32767).astype(np.int16)),
        torch.full((bsz,), samples, dtype=torch.int32),
        torch.from_numpy(rng.randint(4, VOCAB, size=(bsz, THROUGHPUT_LABEL_LEN))
                         .astype(np.int32)),
        torch.full((bsz,), THROUGHPUT_LABEL_LEN, dtype=torch.int32),
    ]
    batch = [x.to(dev) for x in batch]
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    return train_step, init_fn(), batch


def measure_streaming_throughput(dev, n_warmup=3, n_timed=20) -> dict:
    """The streaming recipe's step on one fixed batch of 64 x 8 s with the
    window on (K6/K7) and off (K1/K2), back to back in this process;
    returns the launches per step of the windowed route."""
    per_step = {}
    for window in ("1", "0"):
        train_step, state, batch = streaming_train_setup(dev)
        with banded_window(window):
            for _ in range(n_warmup):
                state, m = train_step(state, *batch, 0)
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            for _ in range(n_timed):
                state, m = train_step(state, *batch, 0)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / n_timed
            counts = read_counters()
        fwd, bwd = (("banded_attention_fwd", "banded_attention_bwd") if window == "1"
                    else ("fused_attention_fwd", "fused_attention_bwd"))
        require(counts[fwd] == 6 * n_timed and counts[bwd] == 6 * n_timed,
                f"streaming throughput launches {counts}")
        require(np.isfinite(float(m["loss"])), "streaming throughput loss not finite")
        route = "windowed K6/K7" if window == "1" else "full-tile K1/K2"
        print(f"streaming train throughput, {route}, bf16, batch 64 x 8 s, {n_timed} "
              f"steps after {n_warmup} warm-up: {step_s * 1e3:.3f} ms/step, "
              f"{1.0 / step_s:.4f} steps/s, {THROUGHPUT_BATCH * THROUGHPUT_SECONDS / step_s:.1f} "
              f"audio-s/s, final loss {float(m['loss']):.4f}")
        if window == "1":
            per_step = {k: v / n_timed for k, v in counts.items()}
        del train_step, state
        torch.cuda.empty_cache()
    return per_step


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.3f} s: {lib_path}")

    fbank = check_fbank(dev)
    attn = check_attention(dev)
    attn_bwd = check_attention_bwd(dev)
    banded_fwd, banded_bwd = check_banded(dev)
    ctc_alpha, ctc_beta = check_ctc(dev)
    serve, serve_batches = run_serving_path(dev)
    trained, corpus = run_training_path(dev)
    check_step_against_cpu(corpus, dev)
    stream_trained, stream_exp = run_streaming_training(corpus)
    stream_served = run_streaming_serving(stream_exp, corpus["vocab"], dev)
    flagship_step = measure_training_throughput(dev)["launches_per_step"]
    streaming_step = measure_streaming_throughput(dev)

    # launches: the main paths' runs, each counted from 0
    launches = {
        k: serve[k] + trained[k] + stream_trained[k] + stream_served[k] for k in COUNTERS
    }
    require(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    sources = {
        "fbank": ("fbank.cu", "asr_chinese_e2e_tpu/ops/fbank_pallas.py:43", fbank),
        "fused_attention_fwd": ("fused_attention_fwd.cu",
                                "asr_chinese_e2e_tpu/ops/fused_attention.py:126", attn),
        "fused_attention_bwd": ("fused_attention_bwd.cu",
                                "asr_chinese_e2e_tpu/ops/fused_attention.py:157", attn_bwd),
        "banded_attention_fwd": ("banded_attention.cu",
                                 "asr_chinese_e2e_tpu/ops/fused_attention.py:383", banded_fwd),
        "banded_attention_bwd": ("banded_attention.cu",
                                 "asr_chinese_e2e_tpu/ops/fused_attention.py:405", banded_bwd),
        "ctc_alpha": ("ctc.cu", "asr_chinese_e2e_tpu/ops/ctc_pallas.py:47", ctc_alpha),
        "ctc_beta": ("ctc.cu", "asr_chinese_e2e_tpu/ops/ctc_pallas.py:75", ctc_beta),
    }
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"asr_chinese_e2e_tpu_torch/ops/csrc/{src}", "replaces": rep,
         "launches": launches[name],
         "launches_per_step": {
             "flagship_train_step": flagship_step[name],
             "streaming_train_step": streaming_step[name],
             "serving_batch": serve[name] / serve_batches,
         }, **measured}
        for name, (src, rep, measured) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
