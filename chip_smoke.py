#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then drives the
serving path (``asr_chinese_e2e_tpu_torch.recognize``, every mode) and the
training path (``asr_chinese_e2e_tpu_torch.main.train``) on the flagship
configuration with random weights, then trains and serves the streaming
model family (causal-banded encoder) through ``main.train`` and
``asr_chinese_e2e_tpu_torch.stream``, then the conformer family (trained,
served, streamed), then the RNN family (BiLSTMCTC and LAS, trained and
served), SpecAugment's time warp and ``attn_impl="flash"``, then the
feature cache (``preprocess features``, training from it), the trainer's
trace window and the soak driver, then two ranks on the one card
(data-parallel training and the distributed beam), then the measuring
programs (``asr_chinese_e2e_tpu_torch/bench.py``, the decode and stream
benches, the decode profile), and checks that every path went through its
kernels.
Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero; phases 3-17, 8b,
9b, 14b, 15b and 15c each print the seconds they took; 8b runs after 8, 9b
after 9, 14b after 14, 15b and 15c after 15):

1. require CUDA; print the card (``nvidia-smi``); TF32 off for matmuls
   (cuDNN's stays at PyTorch's default: the port's cuDNN layers turn it off);
2. build the kernels (``ops/_build.py``, one nvcc per source in parallel)
   and print the build time;
3. K5 fbank kernel vs ``log_mel_spectrogram``: log-mel abs diff and mel
   energy rel diff <= 1e-3 on every band an f32 DFT resolves (at least
   1e-6 of its frame's strongest; on the weaker ones the plain version's
   own rounding passes 1e-3, so there the kernel is held to a float64
   evaluation: within 1e-3, or no farther than twice the plain version),
   at the serving batch (8, 128000), the training batch (64, 128000), an
   odd length, speech-like waves with zero tails (tones plus noise 0.01
   as the synthetic corpus makes them) and 40 filters beside 80. Here and
   in phases 4-7
   a kernel is timed in turns (through the function the main path calls
   it by: allocations included, the call's one validation and host sync
   not) with its plain version and, where one
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
   query row over 267 keys, a causal band 50 whose keys end 50 rows
   before the queries do, and the training shape under a causal band 50
   with dropout 0.1; at the training and serving shapes also the device
   time of the C entry point alone (20 launches back to back; at the
   training shape K1 is called as for a backward, writing the row
   log-sum-exp and the rounding residual of its bf16 output too);
5. K2 attention backward (through the autograd Function, after K1 saved
   the row log-sum-exp) vs ``attention_backward_reference``: dq, dk, dv
   f32 <= 1e-4 abs, bf16 <= 2e-2 abs of the f32 reference, same cases;
   the same times, and beside ``ms`` (the launch function the autograd
   Function's backward runs) ``checked_ms`` (the public wrapper, with its
   validation and host sync) and the validation alone on the host's clock
   (``check_ms``); with query rows that see no key at all (causal band
   20, 267 rows over 100, 30 and 25 keys) K1 and K2 must agree too, f32
   and bf16, within the same bounds: such a row weighs every key alike,
   which K2 rebuilds from the row max and log-sum that K1 saves apart;
6. K6/K7 windowed causal-band attention (through the autograd Function
   with ``ASR_BANDED_WINDOW=1``) vs ``banded_attention_reference`` and
   ``banded_attention_backward_reference``, same bounds (bf16: the
   tensor-core kernels; f32: the FMA kernels), at the streaming training
   shape (64, 8, 267, 64) band 50 with and without hash dropout 0.1, the
   streaming serving shape (1, 8, 501, 64), (2, 8, 150, 64) band 30 with
   lengths [150, 97], bands 64, 65 and 128 at T = 501, band 704 at T =
   1500 (the twelve resident tiles a block can hold; a bf16 window of
   more must be refused by the bare entry before any launch, and f32
   must serve it; through the autograd Function a bf16 band 769 at (1, 8,
   1500, 64) with hash dropout 0.1 takes K1/K2 once each and no K6/K7,
   within 2e-2 of the windowed plain versions on f32 copies), head
   dim 32, the short segments of the prefix re-encode (T = 67 and T = 11)
   and a length that is no multiple of 16; K6 vs K1 on the same f32
   inputs with dropout 0.1 <= 1e-5 abs, and on the same bf16 inputs K6 vs
   K1 and K7 vs K2 <= 2e-2 (each beside its distance to the f32 plain
   version, <= 2e-2 too); at the training shape the median times of K6, its
   plain version, K1 and the library call, and of K7, its plain version,
   K2 and the library call, with dropout 0.1 and with none, and the
   device times of the C entry points alone; K6 also at the serving
   shape;
7. K3/K4 CTC vs ``ctc_alpha_reference`` / ``ctc_beta_reference`` and the
   loss vs ``F.ctc_loss`` at (64, 267, 4233), ragged lengths, label pad
   32, at (8, 501, 4233) with label pad 200 (S = 401) and at (64, 267,
   4233) with repeated labels, f32 and bf16:
   loss rel <= 1e-4, gradient abs <= 1e-3 (f32; 1e-2 in bf16, where both
   sides round the gradient to bf16); K3's alpha table on the rows t < len
   within 1e-4 of max(1, |plain|) on the cells the plain version reaches
   and log-zero (<= -1e29) on both sides on the others, its log-sum-exp
   within 1e-5 abs; times at the first two in bf16 and at the first in f32
   (the RNN family's logits), and the two launches of K3 (row pass,
   recursion) and of K4 (recursion, gradient rows) timed apart under the
   profiler; then f32 logits at a fresh model's loss scale (near-uniform
   rows, loss ~1700 a row) against a float64 evaluation and the plain f32
   recursion (``F32_BOUNDS``, which the design before the accurate expf /
   log1pf and the rows of z normalised by their sum missed);
8. the serving path: a 512-wide, 6+6-layer, bf16 SpeechTransformer with a
   4233-token vocabulary decodes 16 synthetic utterances of 2-8 s (beam
   10, batches of 8); every utterance needs a finite-scored hypothesis,
   the fbank kernel must run once and the attention kernel 6 times per
   batch, and the kernel path's f32 encoder output must agree with the
   CPU run of the plain path (which the CPU tests hold to the JAX
   package); then the bf16 serving chain on the 16 utterances in batches
   of 8 (K5 1 and K1 6 a batch, counted; the encoder, the first decode
   step from BOS, a beam 10 search of 12 steps) on the card against the
   plain path on the CPU in bf16: each distance (max and mean abs; for
   the n-best scores over the rows whose tokens agree) at most
   ``SERVE_BF16_C`` (2, max) and
   ``SERVE_BF16_C_MEAN`` (1.5, mean) times the CPU's own bf16-vs-f32
   distance, the yardstick with which ``tests/test_torch_bf16_parity.py``
   holds the CPU's bf16 to the JAX package's; the shares of equal best
   hypotheses and n-best rows printed, not gated;
8b. decoding modes, K8 and K9: the joint search's CTC prefix registers
   kernel (K8, a warp scan) vs ``ctc_selected_registers_reference`` at the
   serving shape (8, 10, 288) with ragged frame masks, at 15 s (8, 10,
   512) and at the bench decode's (64, 10, 267), parents empty and not,
   tokens equal to the parent's last on every third hypothesis (1e-5 of
   max(1, |plain|) on reachable cells, log-zero on both sides elsewhere;
   ``ms``, ``plain_ms``, ``device_ms`` of 20 calls back to back, the
   kernel alone under the profiler, ``bound_ms``; no PyTorch call
   computes it); the device CTC prefix beam (K9) vs
   ``ctc_prefix_beam_reference`` at beam 10, prune 8, L 64 on the
   flagship's CTC log-probs of phase 8's first serving batch, on peaky
   rows and on rows with planted ties at (8, 288, 4233) and at 15 s (8,
   512), and at its limits, beam 32, prune 32, L 128 at (4, 288, 4233)
   and peaky rows at L 8 (8, 288, 4233), whose prefixes reach L, ragged
   lengths (prefixes and lengths identical, scores within 1e-5 of max(1,
   |plain|), one wrapper launch a call; ``ms``, ``plain_ms``,
   ``device_ms``, the row pass and the recursion apart under the
   profiler, ``bound_ms`` over the frames t < len at the serving batch
   and at 15 s; the wall time of one call, its one wrapper launch by the
   counter and its two kernels);
   then phase 8's experiment and 16 utterances through ``recognize`` in
   every mode (``ctc_greedy``, ``attention_greedy``, ``beam``, ``rescore``
   with the device and the host prefix beam, ``joint`` at ctc_weight 0.3
   and prune 30): a hypothesis for every utterance, finite scores (beam,
   joint, attention_greedy), K5 1 and K1 6 per batch, K8 once per decode
   step in ``joint`` and never in the others, K9 once per batch in
   ``rescore`` with the device prefix beam and never in the others (the
   plain loop never runs on a CUDA tensor), encode and search ms per
   batch of 8 and audio-s/s; and on one batch of 8 the joint search
   with K8 and with the plain recursion forced (identical tokens, scores
   within 1e-4), in f32 at ctc_weight 0 with the whole vocabulary as
   prune (the tokens of ``beam_search``), and at ctc_weight 1 on 2
   utterances (the best hypothesis' score within 1e-3 of max(1, |oracle|)
   of the float64 host oracle ``ctc_prefix_scores_host``: the
   complete-sequence probability if it finished, else the prefix
   probability of its last extension);
9. the training path: ``main.train`` with the flagship recipe (bf16,
   CTC 0.3 through K3/K4, fused attention with hash dropout 0.1,
   SpecAugment, Noam + Adam, clip 5) on 128 synthetic 8 s utterances (2
   batches of 64) and 16 dev utterances, 2 epochs; every logged loss
   finite; per train step K5 1, K1 6, K2 6, K3 1, K4 1 launches (plus
   K5 1, K1 6, K3 1 per dev batch); ``scalars.jsonl`` and ``index.json``
   written; a second ``train(from_ckpt="latest", num_epoch=3)`` resumes
   at the saved step and epoch; the best checkpoint decodes the dev set
   through ``recognize`` on the card;
9b. ``Trainer.evaluate`` on that best checkpoint with ``eval_decode``
   ``ctc_greedy``, ``attention_greedy``, ``beam`` and ``joint`` (beam 10):
   a finite ``dev/decoded_cer`` each;
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
    ``ctc_greedy``, ``beam`` (10) and ``joint`` (10, ctc_weight 0.3; the
    first 2 streams) finals, in bf16 and in f32 (the same weights; K8 once
    per decode step of a joint final); in f32 the incremental finals must equal the prefix
    re-encode finals and the accumulated incremental encoder output must
    be within 1e-3 of the offline encode of the bucketed segment; in
    bf16 the number of agreeing finals is printed; median and p90 ms of
    a partial and of a final in each mode;
13. throughput: ``asr_chinese_e2e_tpu_torch.bench.main`` (the JAX bench's
    recipe and fixed batch of 64 x 8 s: a first step, 2 warm-up steps, 20
    timed), its JSON line; per step (all 23 counted) K5 1, K1 6, K2 6, K3
    1, K4 1 and nothing else; ms per step, steps/s, audio-s/s and MFU
    against the H100 SXM dense bf16 peak;
14. streaming throughput: the streaming recipe on one fixed batch of
    64 x 8 s, one model, 3 warm-up steps on each route, then 5 pairs of
    segments of 4 timed steps, one with ``ASR_BANDED_WINDOW=1`` (K6/K7)
    and one with ``=0`` (K1/K2), the order swapped from pair to pair: ms
    per step of every segment, each route's median and audio-s/s, and in
    how many pairs the window won;
14b. the conformer family (the registry's ``Conformer``: conformer blocks
    with depthwise conv 15, pre-LN, flagship widths): ``main.train
    --model_name Conformer`` with the flagship recipe on phase 9's corpus,
    1 epoch, losses finite, per step K5 1, K1 6, K2 6, K3 1, K4 1 (per dev
    batch K5 1, K1 6, K3 1); the best checkpoint through ``recognize`` in
    ``beam`` and ``joint`` on the 16 dev utterances (per batch K5 1, K1 6;
    K8 once per joint decode step; a finite hypothesis for every
    utterance); a conv2d-frontend conformer: one train step and one beam
    decode of 8 x 8 s, K1 on ceil(ceil(T/2)/2) query rows; one step
    with ``remat`` off and on from the same weights (hash dropout 0.1: loss
    and gradient norm within 1e-5 relative, K1 12 launches with remat: the
    forward and the recompute); one f32
    conformer step on the card vs the CPU's plain path (loss and gradient
    norm within 1e-3 relative, as phase 10, the six parameters with
    the largest share of the gradient difference, card against CPU, and
    every parameter's gradient within 1e-5 relative of the CPU's, but the
    key projections' biases, zero in exact arithmetic;
    ``scripts/conformer_grad_gap_torch.py`` takes the gap apart); the
    pad-leak check: the same
    dev utterances' features and their copy padded by 50 frames of noise
    (std 30) give the same valid encoder rows (bf16 within 2e-2, f32 within
    1e-4; bit-identity printed); the streaming conformer
    (``artifacts/r5_streaming/config.json``'s recipe with conformer blocks)
    through ``main.train`` with ``ASR_BANDED_WINDOW=1``, 1 epoch, per step
    K5 1, K6 6, K7 6, K3 1, K4 1 and no K1/K2, then served in f32 on 2 of
    phase 12's streams in both encode modes with ``ctc_greedy`` and
    ``beam`` finals (incremental finals equal to the prefix re-encode's,
    incremental encoder output within 1e-3 of the offline encode); 10 timed
    steps of the conformer recipe on phase 13's batch: ms per step,
    audio-s/s, MFU (the conformer's FLOPs: its second FFN, the conv
    module's pointwise and depthwise convolutions);
15. the RNN family at the registry's widths, f32, random weights from seed
    0, vocabulary 4233: ``BiLSTMCTC`` (2 x BiLSTM 128, CTC 1.0) and
    ``LAS`` (3 x BiLSTM 256, location-aware attention 256 with 10 x 31
    location filters, CTC 0.3), each trained by ``main.train`` 1 epoch on
    phase 9's corpus with ``eval_decode`` (``ctc_greedy``, ``beam``) from
    cuDNN's TF32 at PyTorch's default (the port must turn it off): losses
    finite, a finite ``dev/decoded_cer``, per step K5 1, K3 1, K4 1
    and no attention kernel (per dev batch K5 2: the loss and the decode;
    K3 1); served by ``recognize`` on the 16 dev utterances in every mode
    the JAX package serves it in (BiLSTMCTC ``ctc_greedy``; LAS
    ``ctc_greedy``, ``attention_greedy``, ``beam``, ``joint``: per batch K5
    1, K8 once per joint decode step, a finite hypothesis for every
    utterance), each mode it cannot serve raising as there; one f32 step
    on the card vs the CPU's plain path (loss and gradient norm within 1e-3
    relative, as phase 10); 10 timed steps on phase 13's batch: ms per
    step, audio-s/s, MFU against 67 TFLOP/s f32 (LSTM gates, location
    attention and heads counted) and device ms per step (3 steps under the
    profiler);
15b. the time warp on the card vs the CPU on the same draws (the fixed
    batch's log-mel, 64 x 801 x 80, within 1e-3), one flagship step with a
    time warp in its SpecAugment (launches as a flagship step), and
    flagship steps with ``attn_impl="flash"`` and with ``"fused"`` from the
    same weights and draws, at dropout 0 and at hash dropout 0.1 (there
    ``"fused"`` without the attention-weight dropout): bit-identical loss
    and gradient norm, K1 6 and K2 6 each;
15c. the feature cache, the trace window and the soak driver on phase 9's
    corpus: ``preprocess features`` on the card over the train and dev
    manifests (K5 once per chunk of 32 and nothing else; each cached
    ``.npy`` within 1e-5 abs of ``parse_batch`` of its wave alone at its
    chunk's width, the distance unpadded printed); ``Trainer(raw_features=
    True)`` over cached-feature loaders, the flagship recipe 1 epoch with
    ``eval_decode=joint`` (losses finite; per train step K5 0, K1 6, K2 6,
    K3 1, K4 1; per dev batch K5 0, K1 12 (the eval step and the decode's
    encode), K3 1; K8 once per joint decode step); one f32 step from the
    cache and one from the waves of one 16-utterance chunk, same weights,
    no SpecAugment, dropout 0 (loss and gradient norm within 1e-5
    relative); ``main.train`` with ``profile_from_step=2 profile_steps=2``
    (one trace under ``exp_dir/trace/`` with two ``train_step`` ranges and
    inside the card's ranges each kernel of a train step, K1-K5, by name,
    exactly as often as two steps launch it, none outside);
    ``scripts/soak_flagship_torch.py``'s phase functions at flagship width,
    3 epochs of 2 batches, ``save_every_iter=1``, killed at the first
    checkpoint at step >= 2, resumed at the saved step, then ``joint`` and
    ``beam`` decodes of the dev set (CER printed);
16. parallel on the card: two ranks on the one H100 (spawned, gloo with
    CUDA tensors) train the flagship recipe (hash dropout 0.1, no
    SpecAugment, a constant lr of 1e-3) 3 steps on a global batch of 16 x
    8 s, 8 rows each, in f32 and in bf16 (the activations' hash dropout;
    the attention weights' folds the rank into its seed, as JAX's sharded
    call, so it is off), against one process on the same global batch:
    losses and gradient norms within 1e-5 relative in f32 (2e-2 in bf16),
    per parameter the first step's gradient and the move over the steps
    within ``PARALLEL_GRAD_REL`` / ``PARALLEL_MOVE_REL`` (|diff| / |ref|);
    per rank and step K5 1, K1 6, K2 6, K3 1,
    K4 1; ms per step on a rank beside one process's;
    ``distributed_beam_search`` of phase 8's first serving batch (an f32
    seed-0 flagship, beam 10) over the two ranks: tokens and finished
    flags equal to one process's ``beam_search``, scores within 1e-5 of
    max(1, |score|); ring attention and tensor
    parallelism on a (1, 1, 1) mesh equal to the unsharded model, bit for
    bit;
17. the benches, each at flagship width but short:
    ``bench.via_trainer_main`` on 4 batches of 64 x 8 s (per step the
    flagship step's launches), ``scripts/bench_decode_torch.py`` in
    ``lazy``, ``gather`` and ``joint`` with one timed search each (per
    batch of 64 K5 1 and K1 6 for the encode, K8 once per decode step of
    ``joint`` and never in the others; ``lazy`` against ``gather``: in
    bf16 the shares of equal best hypotheses and n-best printed, in f32
    (one more run of both) every best hypothesis equal and the scores
    within 1e-5 of max(1, |score|): the two reorders round in other
    orders, so a near tie lower in the n-best may part),
    ``scripts/bench_stream_torch.py`` at bucket 8 s with 2
    timed calls a path, one component pass of
    ``scripts/profile_torch_decode.py`` and ``bench.scaling_main`` at count
    1 (one NCCL rank in its own process): every number finite and
    positive;
18. print the kernels' JSON line (per kernel: route, source, the TPU
    kernel it replaces, launches on the main paths (the conformer's and the
    RNN family's and phase 15c's included) and per flagship train step,
    streaming train step, conformer train step, BiLSTMCTC and LAS train
    step, flash train step, cached-feature train step, beam, joint and rescore serving
    batch, LAS joint decode step, bench-decode batch of 64 per mode (K8 also per
    joint decode step), and at the
    training shape ``shape``, ``max_abs_err``, ``ms``, ``plain_ms``,
    ``bound_ms``, ``bound_by``, ``library_ms``, ``device_ms`` (20 launches
    back to back: of the C entry point for the attention kernels, of the
    wrapper for K3-K5, K8 and K9), for K2 and K7 ``checked_ms``, for K8
    and K9 ``profiler_ms`` (the kernels alone: K8 at the serving shape,
    K9 at the serving batch, its row pass and recursion apart);
    ``other_shapes`` holds the same for the serving shapes, for K3/K4
    for f32 logits at the training shape, for K8 at 15 s and the bench
    decode's shape, for K9 at 15 s), the card line, and last
    ``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from asr_chinese_e2e_tpu_torch import bench  # noqa: E402
from asr_chinese_e2e_tpu_torch.bench import (  # noqa: E402
    H100_SXM_BF16_PEAK,
    H100_SXM_BYTES_PER_S,
    H100_SXM_F32_PEAK,
    RNN_NAMES,
    analytic_train_flops,
    card_line,
)
from asr_chinese_e2e_tpu_torch.core.config import Config, resolve_config  # noqa: E402
from asr_chinese_e2e_tpu_torch.core.registry import get_model  # noqa: E402
from asr_chinese_e2e_tpu_torch.data import timewarp  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.batching import BucketedLoader  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import (  # noqa: E402
    FeatureConfig,
    dft_basis,
    frame_signal,
    log_mel_spectrogram,
    mel_filterbank,
    parse_batch,
)
from asr_chinese_e2e_tpu_torch.data.io import load_wav  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.manifest import read_manifest  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import BOS_ID, Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode import joint as joint_mod  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.ctc_prefix_device import (  # noqa: E402
    ctc_prefix_beam_device,
    ctc_prefix_beam_reference,
)
from asr_chinese_e2e_tpu_torch.decode.distributed import distributed_beam_search  # noqa: E402
from asr_chinese_e2e_tpu_torch.main import data_config  # noqa: E402
from asr_chinese_e2e_tpu_torch.main import train as main_train  # noqa: E402
from asr_chinese_e2e_tpu_torch.models import layers as layers_mod  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import (  # noqa: E402
    SpeechTransformer,
    default_config,
)
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc as ctc_ops  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel as ctc  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_beam_kernel as k9  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_kernel as k8  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel  # noqa: E402
from asr_chinese_e2e_tpu_torch.parallel.context import active_mesh  # noqa: E402
from asr_chinese_e2e_tpu_torch.parallel.dryrun import run_ranks  # noqa: E402
from asr_chinese_e2e_tpu_torch.parallel.sharding import (  # noqa: E402
    batch_rows,
    make_mesh,
    shard_model_,
)
from asr_chinese_e2e_tpu_torch.preprocess import features as preprocess_features  # noqa: E402
from asr_chinese_e2e_tpu_torch.recognize import (  # noqa: E402
    _load_experiment_cached,
    batched,
    recognize,
)
from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer  # noqa: E402
from asr_chinese_e2e_tpu_torch.train.optimizer import (  # noqa: E402
    default_train_config,
    make_optimizer,
    model_width,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns  # noqa: E402
from asr_chinese_e2e_tpu_torch.train.trainer import Trainer  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.experiment import (  # noqa: E402
    checkpoint_path,
    feature_config_from,
    load_experiment,
    save_torch_checkpoint,
)
from asr_chinese_e2e_tpu_torch.utils.synth import (  # noqa: E402
    char_freqs,
    make_synth_corpus,
    synth_wave,
    tone_chars,
)

sys.path.insert(0, os.path.join(ROOT, "scripts"))
import bench_decode_torch  # noqa: E402
import bench_stream_torch  # noqa: E402
import profile_torch_decode  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
N_TIMED = 30
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
    "ctc_prefix": k8.ctc_selected_registers_kernel,
    "ctc_prefix_beam": k9.ctc_prefix_beam_kernel,
}


def reset_counters() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counters() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


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
    What the forward keeps per query row (8 bytes or 4), under 1 % of the
    bytes, is left out."""
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
    the three-way log-add-exp per table cell, in f32. The (B, T, S) emission
    table that the row pass writes and the recursion reads is the kernel's
    own scratch, not an output of the function, and is not counted."""
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


def _device_times(what, shape, device_ms: float, limits: dict) -> dict:
    """Print and return the device time of a kernel's C entry point,
    launched back to back."""
    print(f"{what} {shape} bf16, device time of the entry point alone ({DEVICE_REPS} "
          f"launches back to back, median of 10): {device_ms:.4f} ms "
          f"({limits['bound_ms'] / device_ms * 100:.1f} % of the bound)")
    return {"device_ms": device_ms}


def _wrapper_device_times(what, shape, fn, limits: dict) -> dict:
    """The same for a kernel that outlasts its wrapper's host work (K3-K5):
    the wrapper itself, called back to back."""
    device_ms = turns_ms({"kernel": fn}, n=5, reps=DEVICE_REPS)["kernel"]
    print(f"{what} {shape}, device time ({DEVICE_REPS} calls of the wrapper back to back, "
          f"median of 10): {device_ms:.4f} ms "
          f"({limits['bound_ms'] / device_ms * 100:.1f} % of the bound)")
    return {"device_ms": device_ms}


def _print_times(what, shape, times: dict, limits: dict, n=N_TIMED // 2) -> None:
    parts = [f"{k} {v:.4f} ms" for k, v in times.items()]
    print(f"{what} {shape}: " + ", ".join(parts) + f"; bound {limits['bound_ms']:.4f} ms "
          f"by {limits['bound_by']} ({limits['bytes'] / 1e6:.1f} MB, "
          f"{limits['flops'] / 1e9:.2f} GFLOP): kernel at "
          f"{limits['bound_ms'] / times['kernel'] * 100:.1f} % of it (in turns, median of "
          f"{2 * n})")


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


def speech_waves(b, s, seed=0):
    """Speech-like waves as ``make_synth_corpus`` writes them: whole 0.3 s
    tones with 10 ms fades plus noise 0.01 (``utils/synth.py::synth_wave``),
    quantised to int16 and scaled back, zero past ragged lengths (one to
    eight tones short of ``s``)."""
    rng = np.random.RandomState(seed)
    chars, freqs = tone_chars(40), char_freqs(40)
    tone = int(0.3 * 16000)
    pcm = np.zeros((b, s), np.int16)
    for i in range(b):
        n_tones = s // tone - i % 8
        x = synth_wave("".join(rng.choice(list(chars), size=n_tones)), chars, freqs, rng)
        pcm[i, : len(x)] = (x * 32767).astype(np.int16)
    return pcm


def _logmel_f64(wave, cfg):
    """The plain version's function evaluated in float64 (a diagnostic of
    the f32 roundings, not a bound)."""
    cos_b, sin_b = (torch.from_numpy(a).to(wave.device, torch.float64) for a in dft_basis(cfg))
    frames = frame_signal(wave.double(), cfg)
    re, im = frames @ cos_b, frames @ sin_b
    fb = torch.from_numpy(mel_filterbank(cfg)).to(wave.device, torch.float64)
    return torch.log((re * re + im * im) @ fb + 1e-20)


# (name, shape, waves, n_mels): the serving and training batches, an odd
# length, speech-like waves with zero tails, and 40 mel filters beside 80
FBANK_CASES = [
    ("serve", (8, 128000), "int16", 80),
    ("train", (64, 128000), "int16", 80),
    ("odd-length", (3, 12345), "int16", 80),
    ("speech", (8, 128000), "speech", 80),
    ("speech-n_mels40", (8, 128000), "speech", 40),
    ("n_mels40", (8, 128000), "int16", 40),
]
# bands an f32 DFT resolves: at least this share of their frame's strongest
# band (below it the plain version itself is 1e-3 and more off)
FBANK_RESOLVED = 1e-6


def check_fbank(dev) -> dict:
    """K5 vs ``log_mel_spectrogram``: log-mel max abs <= 1e-3 and mel-energy
    max rel <= 1e-3 on every band an f32 DFT resolves (``FBANK_RESOLVED``);
    on the weaker bands, where the plain version's own f32 rounding passes
    that bound, the kernel within it of a float64 evaluation, or no farther
    from it than twice the plain version is. Each case timed beside its
    bound."""
    rng = np.random.RandomState(0)
    worst, timed = 0.0, {}
    for name, shape, waves, n_mels in FBANK_CASES:
        cfg = FeatureConfig(n_mels=n_mels)
        if waves == "speech":
            pcm = speech_waves(*shape, seed=1)
        else:
            pcm = rng.randint(-32768, 32768, size=shape).astype(np.int16)
        wave = torch.from_numpy(pcm).to(dev).float() * (1.0 / 32768.0)
        got = log_mel_spectrogram_kernel(wave, cfg)
        want = log_mel_spectrogram(wave, cfg)
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"fbank {name} shape {got.shape} vs {want.shape}")
        weak = want < want.amax(-1, keepdim=True) + float(np.log(FBANK_RESOLVED))
        diff = torch.where(weak, torch.zeros_like(want), (got - want).abs())
        max_abs = diff.max().item()
        # relative error of the mel energies, exp(got) vs exp(want): a
        # log-domain relative error is undefined where the log mel crosses 0
        max_rel = torch.expm1(diff).max().item()
        note = ""
        if bool(weak.any()):
            exact = _logmel_f64(wave, cfg)[weak]
            k_off = (got[weak].double() - exact).abs().max().item()
            p_off = (want[weak].double() - exact).abs().max().item()
            note = (f"; {int(weak.sum())} of {weak.numel()} bands under {FBANK_RESOLVED:g} of "
                    f"their frame's strongest: kernel {k_off:.3e} and plain {p_off:.3e} from "
                    f"float64 (kernel {(got - want).abs()[weak].max().item():.3e} from plain)")
            require(k_off <= max(1e-3, 2.0 * p_off), f"fbank {name}: weak bands off")
        print(f"fbank {name} {shape} {waves} n_mels {n_mels}: max_abs={max_abs:.3e} energy "
              f"max_rel={max_rel:.3e}{note}")
        require(max_abs <= 1e-3 and max_rel <= 1e-3, f"fbank {name} disagrees")
        worst = max(worst, max_abs)
        if shape[1] == 128000:
            times = turns_ms({
                "kernel": lambda: log_mel_spectrogram_kernel(wave, cfg),
                "plain": lambda: log_mel_spectrogram(wave, cfg),
            })
            limits = fbank_bound(*shape, cfg)
            what = f"fbank f32 {name} n_mels {n_mels}"
            _print_times(what, shape, times, limits)
            timed[name] = {**_measured(list(shape), max_abs, times, limits), "case": name,
                           "n_mels": n_mels, **_wrapper_device_times(
                               what, shape, lambda: log_mel_spectrogram_kernel(wave, cfg),
                               limits)}
    # no single PyTorch call computes framing + DFT + mel + log: no library time
    return {**timed.pop("train"), "max_abs_err": worst, "other_shapes": list(timed.values())}


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
# 0.1; also under the streaming family's causal band, where few keys share a
# row and the gradients are at their largest), the edges a 64-row tile gets
# wrong first, and a causal band whose keys end ``band`` before the queries
# do (``short_keys``: the last row still sees one key, and the tile ranges
# skip on both sides)
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
    ("train-causal-band50-dropout0.1", 64, 267, 267, True, 50, 0.1, 64),
]
# timed: the training shape first (the kernels' line reports it), then the
# serving shapes
TIMED_ATTENTION = ("train-dropout0.1", "encoder-8s", "encoder-15s")
HEADS = 8


def _attention_fwd_entry(q, k, v, q_len, k_len, seed, scale, rate, causal, band,
                         for_backward=True):
    """A closure that launches the C entry point ``asr_attention_fwd`` into
    buffers made once, which it carries as
    ``launch.out``, ``launch.stats`` (the row max and log-sum) and
    ``launch.out_lo`` (the output's rounding residual, bf16 only; with
    ``for_backward`` off the kernel writes neither, as when no gradient is
    needed). For timing only: no counter, no input checks, no allocation."""
    fn = _build.load_library().asr_attention_fwd
    out = torch.empty_like(q)
    stats = out_lo = None
    if for_backward:
        stats = fa.row_stats_like(q)
        out_lo = torch.empty_like(q) if q.dtype == torch.bfloat16 else None
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_len.data_ptr(), k_len.data_ptr(),
        out.data_ptr(), None if out_lo is None else out_lo.data_ptr(),
        None if stats is None else stats.data_ptr(),
        *q.shape[:3], k.shape[2], q.shape[3], int(q.dtype == torch.bfloat16),
        float(scale), *fa._dropout_args(seed, rate), int(causal), int(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream), "asr_attention_fwd")

    # the pointers in argv stay valid as long as the closure lives
    launch.inputs, launch.out, launch.stats = (q, k, v, q_len, k_len), out, stats
    launch.out_lo = out_lo
    return launch


def _attention_bwd_entry(q, k, v, out, stats, q_len, k_len, seed, scale, rate, causal, band,
                         g, out_lo=None):
    """The same for ``asr_attention_bwd``."""
    fn = _build.load_library().asr_attention_bwd
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out_lo is None else out_lo.data_ptr(), g.data_ptr(),
        stats.data_ptr(), q_len.data_ptr(), k_len.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.shape[:3], k.shape[2], q.shape[3], int(q.dtype == torch.bfloat16),
        float(scale), *fa._dropout_args(seed, rate), int(causal), int(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream), "asr_attention_bwd")

    # the pointers in argv stay valid as long as the closure lives
    launch.buffers = (q, k, v, out, out_lo, stats, q_len, k_len, g, delta)
    launch.grads = (dq, dk, dv)
    return launch


def host_ms(fn, n=N_TIMED) -> float:
    """Median time of ``fn`` on the host's clock with the card idle before
    each call: what a call that waits for the card costs its caller."""
    times = []
    for _ in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[2:])


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
            # as the main path calls it: for the backward at the training shape
            # (the row statistics and the output's residual written too)
            training = b > 8
            extra = ()
            if training:
                extra = (fa.row_stats_like(qb), torch.empty_like(qb))
            with torch.no_grad():
                times = turns_ms({
                    "kernel": lambda: fa._launch(qb, kb, vb, *args, *extra),
                    "library": library,
                    "plain": lambda: fa.attention_reference(qb, kb, vb, *args),
                })
            device = turns_ms({
                "kernel": _attention_fwd_entry(qb, kb, vb, *args, for_backward=training),
            }, n=5, reps=DEVICE_REPS)["kernel"]
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
    gives them the mean of all Tk values, as the plain version does, and
    K2, which rebuilds the weights from the row max and log-sum K1 saved
    apart, their gradient, through the autograd Function, f32 and bf16.
    (No utterance of a single key: that key would gather a band of rows'
    gradient, whose bf16 rounding alone passes the bound.)"""
    q, k, v, q_len, _ = _attn_inputs(4, HEADS, 267, 267, 64, dev, seed=40)
    k_len = torch.tensor([267, 100, 30, 25], dtype=torch.int32, device=dev)
    q_len = torch.full_like(k_len, 267)
    args = (q_len, k_len, 5, 0.125, 0.1, True, 20)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(41)).to(dev)
    errs = {}
    for dtype, limit in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (q, k, v)]
        before = read_counters()
        out = fa.fused_attention_general(*leaves, *args)
        out.backward(g.to(dtype))
        after = read_counters()
        plain = [t.detach().float() for t in leaves]
        want = [fa.attention_reference(*plain, *args),
                *fa.attention_backward_reference(*plain, *args, g.to(dtype).float())]
        torch.cuda.synchronize()
        got = [out, *(t.grad for t in leaves)]
        require(all(bool(torch.isfinite(x).all()) for x in got),
                f"attention with keyless rows, {dtype}: not finite")
        errs[dtype] = [(a.float() - w).abs().max().item() for a, w in zip(got, want)]
        require(max(errs[dtype]) <= limit,
                f"attention with keyless rows, {dtype}: {errs[dtype]}")
        require(after["fused_attention_fwd"] - before["fused_attention_fwd"] == 1
                and after["fused_attention_bwd"] - before["fused_attention_bwd"] == 1,
                f"attention with keyless rows, {dtype}: K1 and K2 did not both launch")
    print("attention with keyless rows (4,8,267,267,64) causal band 20 dropout 0.1, k_len "
          "[267,100,30,25], K1 and K2 launched once each (out, dq, dk, dv): f32 max_abs="
          + ", ".join(f"{e:.3e}" for e in errs[torch.float32]) + "; bf16 max_abs="
          + ", ".join(f"{e:.3e}" for e in errs[torch.bfloat16]))


def _validation_cost(q, k, v, q_len, k_len) -> float:
    """The one validation of an attention call, which waits for the card to
    hand two numbers to the host, on the host's clock with the card idle:
    the forward of the autograd Function pays it once per call, the launch
    functions that ``ms`` times do not, the public backward wrappers
    (``checked_ms``) pay it again."""
    plain = host_ms(lambda: fa._check_kernel_inputs(q, k, v, q_len, k_len))
    print(f"attention {tuple(q.shape)}: validation and host sync of one call "
          f"(_check_kernel_inputs, card idle, host clock, median of {N_TIMED}): {plain:.4f} ms")
    return plain


def check_attention_bwd(dev) -> dict:
    """K2 through the autograd Function (K1 forward saving the row
    statistics, K2 backward) vs the plain backward on the same inputs."""
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
            stats = fa.row_stats_like(qb)
            out_lo = torch.empty_like(qb)
            out = fa._launch(qb, kb, vb, *args, stats, out_lo)
            mask = _sdpa_mask(q_len, k_len, tq, tk, causal, band)
            lib_fwd, lib_both = _sdpa_library(qb, kb, vb, mask, scale, gb)
            times = turns_ms({
                "kernel": lambda: fa._launch_backward(  # what the Function's backward runs
                    qb, kb, vb, out, stats, *args, gb, out_lo),
                # the public wrapper: the same after a validation and host sync
                "checked": lambda: fa.attention_backward_kernel(
                    qb, kb, vb, out, stats, *args, gb, out_lo),
                "library forward": lib_fwd,
                "library forward+backward": lib_both,
                "plain": lambda: fa.attention_backward_reference(qb, kb, vb, *args, gb),
            })
            times["library"] = times["library forward+backward"] - times["library forward"]
            device = turns_ms({
                "kernel": _attention_bwd_entry(qb, kb, vb, out, stats, *args, gb, out_lo),
            }, n=5, reps=DEVICE_REPS)["kernel"]
            limits = attention_bwd_bound(b, HEADS, tq, tk, d)
            _print_times(f"attention bwd {name} bf16 (library: SDPA forward+backward "
                         f"minus forward, dropout 0)", shape, times, limits)
            timed[name] = {**_measured(shape, errs[torch.bfloat16], times, limits),
                           "checked_ms": times["checked"],
                           **_device_times(f"attention bwd {name}", shape, device, limits)}
            if name == TIMED_ATTENTION[0]:
                timed[name]["check_ms"] = _validation_cost(qb, kb, vb, q_len, k_len)
    _check_keyless_rows(dev)
    first, *others = (timed[n] for n in TIMED_ATTENTION)
    return {**first, "max_abs_err": worst, "other_shapes": others}


# -- phase 6: windowed causal-band attention (K6 / K7) --------------------------

# (name, batch, T, band, rate, lengths or None for the training rows, head
# dim): the streaming model's training and serving encoder shapes, a ragged
# case, the bands at either side of BQ = 64 and of one chunk of key groups,
# a window of three resident tiles and one of the twelve a block can hold,
# head dim 32, the short segments of the prefix re-encode, and a length that
# is no multiple of 16
BANDED_CASES = [
    ("train-band50", 64, 267, 50, 0.0, None, 64),
    ("train-band50-dropout0.1", 64, 267, 50, 0.1, None, 64),
    ("serve-501", 1, 501, 50, 0.0, [501], 64),
    ("ragged-band30", 2, 150, 30, 0.0, [150, 97], 64),
    ("band64-501", 2, 501, 64, 0.0, [501, 388], 64),
    ("band65-501", 2, 501, 65, 0.0, [501, 388], 64),
    ("band128-501", 2, 501, 128, 0.1, [501, 388], 64),
    ("band704-1500", 1, 1500, 704, 0.0, [1500], 64),
    ("head-dim-32", 4, 267, 50, 0.1, [267, 200, 100, 7], 32),
    ("segment-67", 1, 67, 50, 0.0, [67], 64),
    ("segment-11", 1, 11, 50, 0.1, [11], 64),
    ("length-203", 2, 267, 50, 0.1, [267, 203], 64),
]


def _banded_inputs(b, t, lengths, dev, seed, d=64):
    q, k, v, q_len, _ = _attn_inputs(b, HEADS, t, t, d, dev, seed)
    if lengths is not None:
        q_len = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, q_len


def _banded_fwd_entry(q, k, v, n, seed, scale, rate, band):
    """A closure that launches ``asr_banded_attention_fwd`` into buffers made
    once (``launch.lse`` is K7's input). For timing only: no counter, no
    input checks, no allocation."""
    fn = _build.load_library().asr_banded_attention_fwd
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *q.shape, int(q.dtype == torch.bfloat16), float(scale),
        *fa._dropout_args(seed, rate), int(band), fa._block_q(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream),
                     "asr_banded_attention_fwd")

    # the pointers in argv stay valid as long as the closure lives
    launch.inputs, launch.out, launch.lse = (q, k, v, n), out, lse
    return launch


def _banded_bwd_entry(q, k, v, lse, n, seed, scale, rate, band, g):
    """The same for ``asr_banded_attention_bwd``."""
    fn = _build.load_library().asr_banded_attention_bwd
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    argv = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        n.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *q.shape, int(q.dtype == torch.bfloat16), float(scale),
        *fa._dropout_args(seed, rate), int(band), fa._block_q(band),
    )

    def launch():
        _build.check(fn(*argv, torch.cuda.current_stream().cuda_stream),
                     "asr_banded_attention_bwd")

    launch.buffers, launch.grads = (q, k, v, lse, n, g, delta), (dq, dk, dv)
    return launch


def _check_banded_cases(dev) -> dict:
    """Every case of ``BANDED_CASES`` through the autograd Function with the
    window on (which must route to K6/K7) vs the plain versions; returns
    each case's bf16 errors, (forward, worst gradient)."""
    worst = {}
    for i, (name, b, t, band, rate, lengths, d) in enumerate(BANDED_CASES):
        q, k, v, n = _banded_inputs(b, t, lengths, dev, seed=20 + i, d=d)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)).to(dev)
        scale = d ** -0.5
        args = (n, n, 4321, scale, rate, True, band)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            leaves = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
            before = [COUNTERS[c].launches for c in (
                "banded_attention_fwd", "banded_attention_bwd", "fused_attention_fwd",
                "fused_attention_bwd")]
            with banded_window("1"):
                out = fa.fused_attention_general(*leaves, *args)
                out.backward(g.to(dtype))
            after = [COUNTERS[c].launches for c in (
                "banded_attention_fwd", "banded_attention_bwd", "fused_attention_fwd",
                "fused_attention_bwd")]
            require([x - y for x, y in zip(after, before)] == [1, 1, 0, 0],
                    f"banded {name}: the window did not route to K6 and K7")
            plain = [x.detach().float() for x in leaves]
            want = fa.banded_attention_reference(*plain, n, 4321, scale, rate, band)
            want_g = fa.banded_attention_backward_reference(
                *plain, n, 4321, scale, rate, band, g.to(dtype).float())
            torch.cuda.synchronize()
            got = [out] + [x.grad for x in leaves]
            require(all(x.dtype == dtype and bool(torch.isfinite(x).all()) for x in got),
                    f"banded {name}: dtype or non-finite")
            pairs = list(zip(got, [want, *want_g]))
            errs[dtype] = [(x.float() - w).abs().max().item() for x, w in pairs]
            largest = max(w.abs().max().item() for _, w in pairs[1:])
        e32, e16 = errs[torch.float32], errs[torch.bfloat16]
        print(f"banded {name} ({b},8,{t},{d}) band {band} rate {rate}: fwd f32 max_abs="
              f"{e32[0]:.3e} bf16 {e16[0]:.3e}; bwd (dq, dk, dv) f32 "
              f"{', '.join(f'{e:.3e}' for e in e32[1:])} bf16 "
              f"{', '.join(f'{e:.3e}' for e in e16[1:])} (largest |grad| {largest:.3f})")
        require(max(e32) <= 1e-4, f"banded {name} f32 disagrees")
        require(max(e16) <= 2e-2, f"banded {name} bf16 disagrees")
        worst[name] = (e16[0], max(e16[1:]))
    _check_window_refusal(dev)
    _check_wide_window_route(dev)
    return worst


def _check_window_refusal(dev) -> None:
    """A bf16 window of more tiles than a block's shared memory holds is
    refused by the entry point before any launch, and the wrapper says so;
    f32 (the FMA kernels stage tile by tile) serves it."""
    q, k, v, n = _banded_inputs(1, 1500, [1500], dev, seed=50)
    before = read_counters()
    try:
        fa.banded_attention_kernel(*(x.to(torch.bfloat16) for x in (q, k, v)), n, 1, 0.125,
                                   0.0, 769)
    except ValueError as e:
        require("resident tiles" in str(e), f"banded window refusal: {e}")
        print(f"banded (1,8,1500,64) band 769 bf16: refused before any launch ({e})")
    else:
        raise AssertionError("a window of 14 tiles was not refused")
    require(read_counters() == before, "a kernel launched all the same")
    got = fa.banded_attention_kernel(q, k, v, n, 1, 0.125, 0.0, 769)
    err = (got - fa.banded_attention_reference(q, k, v, n, 1, 0.125, 0.0, 769)).abs().max().item()
    require(err <= 1e-4, f"banded band 769 f32 disagrees: {err:.3e}")


def _check_wide_window_route(dev) -> None:
    """Through the autograd Function with the window on, a bf16 band too
    wide for K6/K7 (769 at T = 1500: 14 tiles) takes K1/K2, decided on the
    host, with ``k_lengths`` as both lengths: K1 and K2 once each, K6/K7
    not at all, within 2e-2 of the windowed plain versions on f32 copies
    of the same bf16 inputs (hash dropout 0.1)."""
    q, k, v, n = _banded_inputs(1, 1500, [1400], dev, seed=51)
    q_len = torch.full_like(n, 1500)  # unused on this route, as on the window
    leaves = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(52)).to(
        dev, torch.bfloat16)
    reset_counters()
    with banded_window("1"):
        out = fa.fused_attention_general(*leaves, q_len, n, 777, 0.125, 0.1, True, 769)
        out.backward(g)
    torch.cuda.synchronize()
    counts = read_counters()
    want_counts = {**{c: 0 for c in COUNTERS}, "fused_attention_fwd": 1,
                   "fused_attention_bwd": 1}
    require(counts == want_counts, f"wide window route: launches {counts}")
    plain = [x.detach().float() for x in leaves]
    want = [fa.banded_attention_reference(*plain, n, 777, 0.125, 0.1, 769),
            *fa.banded_attention_backward_reference(*plain, n, 777, 0.125, 0.1, 769,
                                                    g.float())]
    errs = [(x.float() - w).abs().max().item()
            for x, w in zip([out] + [x.grad for x in leaves], want)]
    print("banded (1,8,1500,64) band 769 bf16 dropout 0.1 through the Function: K1/K2, "
          f"(out, dq, dk, dv) max_abs={', '.join(f'{e:.3e}' for e in errs)} against the "
          "windowed plain version")
    require(max(errs) <= 2e-2, "the wide window's full-tile route disagrees")


def check_banded(dev) -> tuple[dict, dict]:
    """K6 and K7 vs their plain versions at every case; K6 vs K1 and K7 vs
    K2; times at the training shape (and K6's at the serving shape)."""
    scale = 1.0 / 8.0
    errs = _check_banded_cases(dev)
    worst = {"fwd": max(e[0] for e in errs.values()), "bwd": max(e[1] for e in errs.values())}

    # K6/K7 and K1/K2 interchangeable mid-training: the same weights dropped
    q, k, v, n = _banded_inputs(64, 267, None, dev, seed=30)
    k6 = fa.banded_attention_kernel(q, k, v, n, 99, scale, 0.1, 50)
    k1 = fa._launch(q, k, v, n, n, 99, scale, 0.1, True, 50)
    torch.cuda.synchronize()
    k6_k1 = (k6 - k1).abs().max().item()
    print(f"banded K6 vs K1, f32 (64,8,267,64) band 50 dropout 0.1: max_abs={k6_k1:.3e}")
    require(k6_k1 <= 1e-5, "K6 and K1 disagree")

    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    gb = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(dev, torch.bfloat16)
    # entry points with their buffers, per dropout rate: (K6, K7, K1, K2)
    entries = {}
    for rate in (0.1, 0.0):
        call = (n, n, 7, scale, rate, True, 50)
        k6e = _banded_fwd_entry(qb, kb, vb, n, 7, scale, rate, 50)
        k1e = _attention_fwd_entry(qb, kb, vb, *call)
        k6e(), k1e()
        entries[rate] = (
            k6e, _banded_bwd_entry(qb, kb, vb, k6e.lse, n, 7, scale, rate, 50, gb), k1e,
            _attention_bwd_entry(qb, kb, vb, k1e.out, k1e.stats, *call, gb, k1e.out_lo),
        )
    k6e, k7e, k1e, k2e = entries[0.1]
    k7e(), k2e()
    torch.cuda.synchronize()
    plain = [x.float() for x in (qb, kb, vb)]
    want = [fa.banded_attention_reference(*plain, n, 7, scale, 0.1, 50),
            *fa.banded_attention_backward_reference(*plain, n, 7, scale, 0.1, 50, gb.float())]
    got = {"K6/K7": [k6e.out, *k7e.grads], "K1/K2": [k1e.out, *k2e.grads]}

    def dist(xs, ys):
        return [(x.float() - y.float()).abs().max().item() for x, y in zip(xs, ys)]

    same = dist(got["K6/K7"], got["K1/K2"])
    off = {name: dist(xs, want) for name, xs in got.items()}
    print("banded K6 vs K1 and K7 vs K2 (out, dq, dk, dv), bf16 (64,8,267,64) band 50 dropout "
          f"0.1: max_abs={', '.join(f'{e:.3e}' for e in same)}; against the f32 plain version "
          + "; ".join(f"{name} {', '.join(f'{e:.3e}' for e in es)}" for name, es in off.items()))
    require(max(same) <= 2e-2, "K6/K7 and K1/K2 disagree in bf16")
    require(max(off["K6/K7"]) <= 2e-2, "K6/K7 disagree with the plain version")
    require(max(off["K1/K2"]) <= 2e-2, "K1/K2 disagree with the plain version")

    # times at the streaming training shape, bf16: through the wrappers, in turns
    # dropout 0.1: what K7 and K2 read
    lse6, stats1, out1, out1_lo = k6e.lse, k1e.stats, k1e.out, k1e.out_lo
    mask = _sdpa_mask(n, n, 267, 267, True, 50)
    lib_fwd, lib_both = _sdpa_library(qb, kb, vb, mask, scale, gb)
    with torch.no_grad():
        fwd = turns_ms({
            "kernel": lambda: fa.banded_attention_kernel(qb, kb, vb, n, 7, scale, 0.1, 50),
            "kernel, dropout 0": lambda: fa.banded_attention_kernel(
                qb, kb, vb, n, 7, scale, 0.0, 50),
            "K1 (causal band 50)": lambda: fa._launch(
                qb, kb, vb, n, n, 7, scale, 0.1, True, 50),
            "library": lib_fwd,
            "plain": lambda: fa.banded_attention_reference(qb, kb, vb, n, 7, scale, 0.1, 50),
        })
    lse6_0 = entries[0.0][0].lse
    bwd = turns_ms({
        # the launch functions: what the autograd Function's backward runs
        "kernel": lambda: fa._launch_banded_backward(
            qb, kb, vb, lse6, n, 7, scale, 0.1, 50, gb),
        "kernel, dropout 0": lambda: fa._launch_banded_backward(
            qb, kb, vb, lse6_0, n, 7, scale, 0.0, 50, gb),
        # the public wrapper: the same after a validation and host sync
        "checked": lambda: fa.banded_attention_backward_kernel(
            qb, kb, vb, lse6, n, 7, scale, 0.1, 50, gb),
        "K2 (causal band 50)": lambda: fa._launch_backward(
            qb, kb, vb, out1, stats1, n, n, 7, scale, 0.1, True, 50, gb, out1_lo),
        "library forward": lib_fwd,
        "library forward+backward": lib_both,
        "plain": lambda: fa.banded_attention_backward_reference(
            qb, kb, vb, n, 7, scale, 0.1, 50, gb),
    })
    bwd["library"] = bwd["library forward+backward"] - bwd["library forward"]
    # the entry points alone, back to back: the kernels' device time
    names = ("K6", "K7", "K1 (causal band 50)", "K2 (causal band 50)")
    device = turns_ms({
        f"{name}, dropout {rate}": entry
        for rate in (0.1, 0.0) for name, entry in zip(names, entries[rate])
    }, n=5, reps=DEVICE_REPS)
    shape = [64, HEADS, 267, 267, 64]
    pairs = band_pairs(n.tolist(), HEADS, 50)
    limits = (attention_fwd_bound(64, HEADS, 267, 267, 64, pairs=pairs),
              banded_attention_bwd_bound(64, HEADS, 267, 64, pairs=pairs))
    what = "bf16 band 50 dropout 0.1 (library: SDPA with the causal-band mask, dropout 0)"
    _print_times(f"banded K6 {what}", shape, fwd, limits[0])
    _print_times(f"banded K7 {what}", shape, bwd, limits[1])
    print(f"banded {shape} bf16 band 50, device time of the entry points alone "
          f"({DEVICE_REPS} launches back to back, in turns, median of 10), ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in device.items())
          + f"; K6 at {limits[0]['bound_ms'] / device['K6, dropout 0.1'] * 100:.1f} % and K7 at "
          f"{limits[1]['bound_ms'] / device['K7, dropout 0.1'] * 100:.1f} % of the bound")

    # K6 at the streaming serving shape (the prefix re-encode takes no gradient)
    qs, ks, vs, ns = _banded_inputs(1, 501, [501], dev, seed=31)
    qs, ks, vs = (x.to(torch.bfloat16) for x in (qs, ks, vs))
    mask_s = _sdpa_mask(ns, ns, 501, 501, True, 50)
    with torch.no_grad():
        serve = turns_ms({
            "kernel": lambda: fa.banded_attention_kernel(qs, ks, vs, ns, 7, scale, 0.0, 50),
            "K1 (causal band 50)": lambda: fa._launch(
                qs, ks, vs, ns, ns, 7, scale, 0.0, True, 50),
            "library": _sdpa_library(qs, ks, vs, mask_s, scale, None)[0],
            "plain": lambda: fa.banded_attention_reference(qs, ks, vs, ns, 7, scale, 0.0, 50),
        })
    serve_device = turns_ms(
        {"kernel": _banded_fwd_entry(qs, ks, vs, ns, 7, scale, 0.0, 50)},
        n=5, reps=DEVICE_REPS)["kernel"]
    serve_shape = [1, HEADS, 501, 501, 64]
    serve_limits = attention_fwd_bound(1, HEADS, 501, 501, 64,
                                       pairs=band_pairs([501], HEADS, 50))
    _print_times("banded K6 bf16 band 50 dropout 0 (library: SDPA with the causal-band "
                 "mask)", serve_shape, serve, serve_limits)
    served = {**_measured(serve_shape, errs["serve-501"][0], serve, serve_limits),
              **_device_times("banded K6", serve_shape, serve_device, serve_limits)}

    def entry(times, lim, err, key, other_shapes):
        return {**_measured(shape, err, times, lim), "device_ms": device[f"{key}, dropout 0.1"],
                "ms_dropout0": times["kernel, dropout 0"],
                "device_ms_dropout0": device[f"{key}, dropout 0.0"],
                "other_shapes": other_shapes}

    return (entry(fwd, limits[0], worst["fwd"], "K6", [served]),
            {**entry(bwd, limits[1], worst["bwd"], "K7", []), "checked_ms": bwd["checked"]})


# -- phase 7: CTC alpha / beta -------------------------------------------------


def _ctc_inputs(dev, dtype, b=64, t=267, c=4233, label_pad=32, seed=0, labels="random"):
    """Logits, ragged logit lengths, labels and their lengths. ``labels``:
    "random" (lengths 1 + 5 i mod the pad), "long" (lengths from the pad
    down by 10 a row: S = 2 pad + 1 states all in use), "repeats" (three
    classes only: labels repeat side by side and apart)."""
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(b, t, c, generator=g) * 2.0).to(dtype)
    lens = torch.tensor([t - (i * 7) % 120 for i in range(b)], dtype=torch.int32)
    if labels == "long":
        lab_lens = torch.tensor([label_pad - 10 * i for i in range(b)], dtype=torch.int32)
    else:
        lab_lens = torch.tensor([1 + (i * 5) % label_pad for i in range(b)], dtype=torch.int32)
    hi = 4 if labels == "repeats" else c
    labels = torch.randint(1, hi, (b, label_pad), generator=g, dtype=torch.int32)
    labels = labels * (torch.arange(label_pad)[None, :] < lab_lens[:, None])
    return [x.to(dev) for x in (logits, lens, labels, lab_lens)]


# (name, batch, T, label pad, labels): the flagship's CTC shape (S = 65), a
# long segment with long labels (S = 401: 416 threads of K4's recursion),
# repeated labels at the flagship's shape
CTC_CASES = [
    ("train", 64, 267, 32, "random"),
    ("long-labels", 8, 501, 200, "long"),
    ("repeats", 64, 267, 32, "repeats"),
]
K3_KERNELS = {"row pass": "ctc_emission_rows_kernel", "recursion": "ctc_alpha_recursion_kernel"}
K4_KERNELS = {"recursion": "ctc_beta_recursion_kernel", "gradient": "ctc_grad_rows_kernel"}
ALPHA_REL = 1e-4  # K3's alpha on reachable cells: of max(1, |plain|), as the loss
LSE_ABS = 1e-5  # a row's log-sum-exp (~10 at C = 4233), in f32 with the hardware's exp
LOG_ZERO = -1e29  # an unreachable cell: log-zero (-1e30) plus emissions


# spin kernels launched and waited for after the profiler starts: in a
# process that has traced before, the card's records of the first launches
# after a start can be missing (``utils/debug.py``); one run lost all 20
# launches of a 9 us kernel that had no warm-up before it
PROFILER_WARMUP = 64
WARMUP_KERNEL = "spin_kernel"  # ``torch.cuda._sleep``'s kernel


@contextlib.contextmanager
def _traced():
    """``torch.profiler`` on the card's activity, started and warmed by
    ``PROFILER_WARMUP`` spin kernels before the region; their records,
    named ``WARMUP_KERNEL``, stay in the trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def _launch_device_ms(fn, names: dict, n=DEVICE_REPS) -> dict:
    """Device ms per launch of each named kernel over ``n`` calls of ``fn``,
    under ``torch.profiler``; traced once more, and said so, if a kernel's
    records are all missing (the launches themselves are counted apart)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with _traced() as prof:
            for _ in range(n):
                fn()
        out = {}
        for e in prof.key_averages():
            for part, kernel in names.items():
                if kernel in e.key and e.count:
                    out[part] = e.self_device_time_total / e.count / 1e3
        if set(out) == set(names):
            break
        print(f"profiler trace {attempt + 1} saw {sorted(out)} of {sorted(names)}")
    require(set(out) == set(names), f"profiler saw {sorted(out)} of {sorted(names)}")
    return out


def _check_alpha_table(what, logits, ext, lens, lab_lens, want_alpha, want_lse) -> float:
    """K3's alpha table on the rows t < len and its log-sum-exp against the
    plain version's: alpha within ``ALPHA_REL`` of max(1, |plain|) where the
    plain version reaches the cell, both log-zero (<= ``LOG_ZERO``) where it
    does not; lse within ``LSE_ABS``. Returns the largest alpha error."""
    ext_i, lens_i, lab_i = ctc._check_kernel_inputs(logits, ext, lens, lab_lens)
    _, alpha, lse = ctc.ctc_alpha_kernel(logits, ext_i, lens_i, lab_i)
    t_idx = torch.arange(alpha.shape[1], device=alpha.device)
    rows = (t_idx[None, :] < lens_i.long()[:, None])[..., None].expand_as(alpha)
    reach = rows & (want_alpha > LOG_ZERO)
    err = (alpha - want_alpha).abs()
    a_err = err[reach].max().item()
    a_rel = (err / want_alpha.abs().clamp(min=1.0))[reach].max().item()
    unreached_ok = bool((alpha[rows & ~reach] <= LOG_ZERO).all())
    l_err = (lse - want_lse).abs().max().item()
    print(f"{what}: K3 alpha on rows t < len max_abs={a_err:.3e} (of max(1, |plain|): "
          f"{a_rel:.3e}) over {int(reach.sum())} reachable cells, "
          f"{int((rows & ~reach).sum())} unreachable ones log-zero on both sides: "
          f"{unreached_ok}; lse max_abs={l_err:.3e}")
    require(a_rel <= ALPHA_REL and unreached_ok, f"{what}: K3's alpha table disagrees")
    require(l_err <= LSE_ABS, f"{what}: K3's log-sum-exp disagrees")
    return a_err


def check_ctc(dev) -> tuple[dict, dict]:
    """K3 and K4 through the autograd Function vs their plain versions (and
    the loss vs F.ctc_loss) at every case of ``CTC_CASES``, f32 and bf16,
    and K3's alpha table and log-sum-exp directly; times at the flagship's
    shape and at the long one, each kernel's two launches apart."""
    worst = {"alpha": 0.0, "beta": 0.0}
    timed = {}
    for name, b, t, label_pad, kind in CTC_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            logits, lens, labels, lab_lens = _ctc_inputs(
                dev, dtype, b=b, t=t, label_pad=label_pad, labels=kind)
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
            dname = str(dtype).replace("torch.", "")
            shape = [b, t, VOCAB]
            print(f"ctc {name} {dname} {tuple(shape)} label pad {label_pad} (S = {ext.shape[1]}, "
                  f"{kind} labels): loss max_rel={rel:.3e} (F.ctc_loss {rel_oracle:.3e}) "
                  f"d_logits max_abs={g_err:.3e}")
            require(x.grad.dtype == dtype, f"ctc {name} {dname}: gradient dtype {x.grad.dtype}")
            require(rel <= 1e-4 and rel_oracle <= 1e-4, f"ctc {name} {dname} loss disagrees")
            # f32: 1e-3; bf16: the gradient is rounded to bf16 on both sides
            require(g_err <= (1e-3 if dtype == torch.float32 else 1e-2),
                    f"ctc {name} {dname} gradient disagrees")
            _check_alpha_table(f"ctc {name} {dname}", logits, ext, lens, lab_lens, alpha, lse)
            worst["alpha"] = max(worst["alpha"], (loss - want_loss).abs().max().item())
            worst["beta"] = max(worst["beta"], g_err)
            # bf16 at both shapes; f32 at the training shape, the RNN
            # family's logits
            if name != "repeats" and (dtype == torch.bfloat16 or name == "train"):
                errs = {"alpha": (loss - want_loss).abs().max().item(), "beta": g_err}
                timed[name, dname] = _time_ctc(logits, ext, lens, labels, lab_lens, g, lse,
                                               alpha, want_loss, shape, errs)
    _check_f32_near_uniform(dev)
    first, other, f32 = (timed[k] for k in (("train", "bfloat16"), ("long-labels", "bfloat16"),
                                            ("train", "float32")))
    return tuple({**first[p], "max_abs_err": worst[p], "other_shapes": [other[p], f32[p]]}
                 for p in ("alpha", "beta"))


# f32 logits at the scale of a freshly initialised model's CTC head
# (near-uniform rows: loss about len ln C, ~1700 a row), against a float64
# evaluation of the plain recursion and against the plain f32 one: (loss
# max_rel, d_logits |diff| / |ref|) bounds, which the kernels' f32 design
# (expf / log1pf, rows of z normalised) meets. The design before it (ex2 /
# lg2, z = exp(alpha + beta' - emit + loss) as it came, each row carrying
# the ulp of the ~1700-sized terms) missed the gradient bounds (PERF.md
# §6). The loss does not tell designs apart: both are f32 sums (~9e-7 from
# float64 here).
F32_BOUNDS = {"float64": (2e-6, 1.5e-4), "plain f32": (2e-6, 3e-5)}


def _check_f32_near_uniform(dev) -> None:
    """K3/K4 on near-uniform f32 logits against float64 and against the
    plain f32 recursion (``F32_BOUNDS``)."""
    logits, lens, labels, lab_lens = _ctc_inputs(dev, torch.float32)
    logits = logits * 0.25  # std 0.5: near-uniform rows
    ext = ctc_ops.extend_labels(labels.long())
    g = torch.linspace(0.5, 1.5, logits.shape[0], device=dev)
    ext_i, lens_i, lab_i = ctc._check_kernel_inputs(logits, ext, lens, lab_lens)
    loss, k_alpha, k_lse = ctc.ctc_alpha_kernel(logits, ext_i, lens_i, lab_i)
    grad = ctc.ctc_beta_kernel(logits, ext_i, lens_i, lab_i, k_lse, k_alpha, loss, g).double()
    for name, x in (("plain f32", logits), ("float64", logits.double())):
        want_loss, alpha, lse = ctc.ctc_alpha_reference(x, ext, lens, lab_lens)
        want_grad = ctc.ctc_beta_reference(
            x, ext, lens, lab_lens, lse, alpha, want_loss, g.to(x.dtype)).double()
        want_loss = want_loss.double()
        rel = ((loss.double() - want_loss).abs() / want_loss.abs()).max().item()
        g_rel = ((grad - want_grad).norm() / want_grad.norm()).item()
        loss_bound, grad_bound = F32_BOUNDS[name]
        print(f"ctc f32 near-uniform (64, 267, {VOCAB}) loss {want_loss.mean().item():.1f} a "
              f"row vs {name}: loss max_rel={rel:.3e}, d_logits |diff| / |ref| {g_rel:.3e} "
              f"(max_abs {(grad - want_grad).abs().max().item():.3e}); bounds "
              f"{loss_bound:g} / {grad_bound:g}")
        require(rel <= loss_bound and g_rel <= grad_bound,
                f"ctc f32 near-uniform: the kernels miss their bound against {name}")


def _time_ctc(logits, ext, lens, labels, lab_lens, g, lse, alpha, want_loss, shape,
              errs) -> dict:
    """K3's and K4's times in turns with the library's pair and the plain
    versions (median of 5), their device times, and each one's two launches
    apart; each beside its bound."""
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

    def k3():
        return ctc.ctc_alpha_kernel(logits, ext_i, lens_i, lab_i)

    def k4():
        return ctc.ctc_beta_kernel(logits, ext_i, lens_i, lab_i, k_lse, k_alpha, k_loss, g)

    timing = {
        "alpha": turns_ms({"kernel": k3, "library": lib_fwd}),
        "beta": turns_ms({
            "kernel": k4,
            "library forward": lib_fwd,
            "library forward+backward": lambda: torch.autograd.grad(lib_fwd(), leaf, g),
        }),
    }
    timing["beta"]["library"] = (timing["beta"]["library forward+backward"]
                                 - timing["beta"]["library forward"])
    timing["alpha"]["plain"] = median_ms(
        lambda: ctc.ctc_alpha_reference(logits, ext, lens, lab_lens), n=5, warmup=1)
    timing["beta"]["plain"] = median_ms(
        lambda: ctc.ctc_beta_reference(
            logits, ext, lens, lab_lens, lse, alpha, want_loss, g), n=5, warmup=1)
    dims = (*shape, ext.shape[1])
    itemsize = logits.element_size()
    dname = "bf16" if logits.dtype == torch.bfloat16 else "f32"
    limits = {"alpha": ctc_alpha_bound(*dims, itemsize=itemsize),
              "beta": ctc_beta_bound(*dims, itemsize=itemsize)}
    for part in ("alpha", "beta"):
        _print_times(f"ctc {part} {dname} (library: F.log_softmax + F.ctc_loss; plain: "
                     f"median of 5)", shape, timing[part], limits[part])
    device = {
        "alpha": _wrapper_device_times(f"ctc alpha {dname}", shape, k3, limits["alpha"]),
        "beta": _wrapper_device_times(f"ctc beta {dname}", shape, k4, limits["beta"]),
    }
    for part, fn, names in (("alpha", k3, K3_KERNELS), ("beta", k4, K4_KERNELS)):
        parts = _launch_device_ms(fn, names)
        print(f"ctc {part} {dname} {shape} S = {ext.shape[1]}, device ms per launch under the "
              f"profiler ({DEVICE_REPS} calls): "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        device[part]["device_ms_launches"] = parts
    return {p: {**_measured(shape, errs[p], timing[p], limits[p]), "S": ext.shape[1],
                "dtype": str(logits.dtype).replace("torch.", ""), **device[p]}
            for p in ("alpha", "beta")}


# -- phase 8: the serving path -------------------------------------------------


def flagship_config(dtype: str) -> Config:
    feat = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, attn_impl="fused", fbank_impl="pallas",
        input_dim=feat.feature_dim,
    )
    return Config(**cfg.to_dict())


def _test_batches(corpus, n: int, batch: int = 8) -> list:
    """The first ``n`` test utterances of ``corpus`` in manifest order, in
    batches of ``batch``, each as (int16 PCM (B, S), lengths (B,))."""
    recs = read_manifest(corpus["test"])[:n]
    out = []
    for start in range(0, len(recs), batch):
        waves = [load_wav(r["wave"], dtype=np.int16) for r in recs[start:start + batch]]
        pcm = np.zeros((len(waves), max(len(w) for w in waves)), np.int16)
        for i, w in enumerate(waves):
            pcm[i, : len(w)] = w
        out.append((torch.from_numpy(pcm),
                    torch.tensor([len(w) for w in waves], dtype=torch.int32)))
    return out


def check_encoder_against_cpu(corpus, vocab_size, dev) -> float:
    """f32 encoder through the kernels on the card vs the plain path on the
    CPU, two utterances of the corpus."""
    cfg = flagship_config("float32")
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0)).eval()
    (pcm, lens), = _test_batches(corpus, 2)
    feat_cfg = FeatureConfig(fbank_impl="pallas")
    with torch.inference_mode():
        f_cpu, fl_cpu = parse_batch(pcm, lens, feat_cfg)
        want, _ = model.encode(f_cpu, fl_cpu)
        model_d = model.to(dev)
        f_d, fl_d = parse_batch(pcm.to(dev), lens.to(dev), feat_cfg)
        got, _ = model_d.encode(f_d, fl_d)
    torch.cuda.synchronize()
    return (got.cpu() - want).abs().max().item()


# phase 8's bf16 gate: the card's bf16 serving chain may be at most C times
# as far from the plain CPU port's bf16 as that is from its own f32 (max
# abs; C_MEAN for the mean abs), the yardstick with which
# tests/test_torch_bf16_parity.py holds the CPU port's bf16 to the JAX
# package's. The chain runs on the corpus' 16 test utterances: an
# utterance's n-best scores shift together with its encoder output's
# rounding, so they are about one draw an utterance (on two utterances the
# n-best ratios read 2.73 / 2.23 on an H100, PERF.md section 6)
SERVE_BF16_C = 2.0
SERVE_BF16_C_MEAN = 1.5
SERVE_BF16_BEAM, SERVE_BF16_MAX_LEN, SERVE_BF16_UTTS = 10, 12, 16


def _serve_chain(model, batches, dev) -> dict:
    """Per batch: features (K5 on the card), the encoder, the first decode
    step from BOS and a beam search; as float32 on the CPU, the batches
    joined (the encoder output's valid rows)."""
    feat_cfg = FeatureConfig(fbank_impl="pallas")
    parts = []
    with torch.inference_mode():
        for pcm, lens in batches:
            feats, feat_lens = parse_batch(pcm.to(dev), lens.to(dev), feat_cfg)
            enc, enc_lens = model.encode(feats, feat_lens)
            state = model.init_decode_state(enc, enc_lens, SERVE_BF16_MAX_LEN + 1, 1)
            bos = torch.full((enc.shape[0],), BOS_ID, dtype=torch.int64, device=dev)
            first, _ = model.decode_step(bos, state, 0)
            res = beam_search(model, enc, enc_lens, SERVE_BF16_BEAM, SERVE_BF16_MAX_LEN)
            res.materialize()
            valid = torch.arange(enc.shape[1])[None] < enc_lens.cpu()[:, None]
            parts.append({"encode": enc.float().cpu()[valid], "first_step": first.float().cpu(),
                          "tokens": res.tokens, "scores": res.scores})
    return {"encode": torch.cat([p["encode"] for p in parts]),
            "first_step": torch.cat([p["first_step"] for p in parts]),
            "tokens": np.concatenate([p["tokens"] for p in parts]),
            "scores": np.concatenate([p["scores"] for p in parts])}


def _serve_distance(name: str, a: dict, b: dict) -> tuple:
    """(max, mean) abs difference of ``name`` between two chains; for the
    n-best scores over the rows whose tokens agree (None when none do)."""
    if name == "nbest":
        agree = (a["tokens"] == b["tokens"]).all(-1)
        if not agree.any():
            return None
        d = np.abs(a["scores"][agree] - b["scores"][agree])
    else:
        d = (a[name] - b[name]).abs().numpy()
    return float(d.max()), float(d.mean())


def check_serving_bf16_against_cpu(corpus, vocab_size, dev) -> dict:
    """The flagship's bf16 serving chain (K5, the encoder through K1, the
    first decode step, a beam 10 search) on the card against the plain
    CPU port in bf16 on the corpus' 16 test utterances in batches of 8,
    each distance held to ``SERVE_BF16_C`` (max) and ``SERVE_BF16_C_MEAN``
    (mean) times the plain CPU port's bf16-vs-f32 distance; the shares of
    equal best hypotheses and n-best rows printed, not gated."""
    weights = SpeechTransformer(flagship_config("bfloat16"), vocab_size,
                                torch.Generator().manual_seed(0)).state_dict()
    batches = _test_batches(corpus, SERVE_BF16_UTTS)
    runs = {}
    for run, dtype, device in (("cpu_f32", "float32", "cpu"), ("cpu_bf16", "bfloat16", "cpu"),
                               ("card_bf16", "bfloat16", dev)):
        model = SpeechTransformer(flagship_config(dtype), vocab_size)
        model.load_state_dict(weights)
        if device != "cpu":
            reset_counters()
        runs[run] = _serve_chain(model.eval().to(device), batches, device)
    counts, n = read_counters(), len(batches)
    require(counts["fbank"] == n and counts["fused_attention_fwd"] == 6 * n,
            f"bf16 chain on the card: launches {counts}, want K5 1 and K1 6 a batch")
    out = {}
    for name in ("encode", "first_step", "nbest"):
        card = _serve_distance(name, runs["card_bf16"], runs["cpu_bf16"])
        noise = _serve_distance(name, runs["cpu_bf16"], runs["cpu_f32"])
        require(card is not None and noise is not None,
                f"bf16 {name}: no n-best row with equal tokens to compare")
        ratios = [c / z for c, z in zip(card, noise)]
        print(f"bf16 {name} card vs cpu: max {card[0]:.6g} mean {card[1]:.6g}; cpu bf16 vs "
              f"f32: max {noise[0]:.6g} mean {noise[1]:.6g}; ratios max {ratios[0]:.4f} "
              f"(<= {SERVE_BF16_C}) mean {ratios[1]:.4f} (<= {SERVE_BF16_C_MEAN})")
        require(min(noise) > 0.0, f"bf16 {name}: the CPU's bf16 equals its f32")
        require(ratios[0] <= SERVE_BF16_C and ratios[1] <= SERVE_BF16_C_MEAN,
                f"bf16 {name}: the card is farther from the CPU than the yardstick allows")
        out[name] = {"card_vs_cpu": card, "cpu_bf16_vs_f32": noise, "ratios": ratios}
    card, cpu = runs["card_bf16"]["tokens"], runs["cpu_bf16"]["tokens"]
    out["best_equal"] = float((card[:, 0] == cpu[:, 0]).all(-1).mean())
    out["nbest_rows_equal"] = float((card == cpu).all(-1).mean())
    print(f"bf16 card vs cpu: best hypotheses equal {out['best_equal']:.3f}, n-best rows "
          f"equal {out['nbest_rows_equal']:.3f} (printed, not gated)")
    return out


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
    t0 = time.perf_counter()
    check_serving_bf16_against_cpu(corpus, vocab.vocab_size, dev)
    print(f"bf16 serving chain card vs cpu: {time.perf_counter() - t0:.1f} s")

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
    return counts, n, corpus, exp


# -- phase 8b: every recognize mode, and the joint search's kernel --------------

K8_REL = 1e-5  # K8's registers on reachable cells: of max(1, |plain|)
JOINT_SCORE_ABS = 1e-4  # joint scores, kernel vs plain recursion (f32 sums alike)
ORACLE_REL = 1e-3  # f32 search vs the float64 host oracle: of max(1, |oracle|)
DECODE_MODES = {
    "ctc_greedy": {}, "attention_greedy": {}, "beam": {},
    "rescore-device": dict(mode="rescore", ctc_beam_impl="device"),
    "rescore-host": dict(mode="rescore", ctc_beam_impl="host"),
    "joint": dict(ctc_weight=0.3, ctc_prune=30),
}


def ctc_prefix_bound(b, k, t) -> dict:
    """K8: the hypotheses' token rows and the utterances' blank rows of the
    table, the parents' two register rows, the frame mask, token and last
    read; the two register rows written; per (hypothesis, frame) three
    log-add-exps (max, difference, exp, log1p, add: 5 operations each) and
    three adds, in f32."""
    n_bytes = 4.0 * (b * k * t + b * t + 4 * b * k * t) + b * t + 16.0 * b * k
    return bound(n_bytes, 18.0 * b * k * t, H100_SXM_F32_PEAK)


def _k8_inputs(dev, b, k, t, seed):
    """Class-major CTC log-probs of the flagship's vocabulary, ragged frame
    masks (the first utterance full), parent registers with log-zero
    stretches, and tokens equal to the parent's last token on every third
    hypothesis."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, VOCAB, generator=g) * 3.0, dim=-1)
    flat = lp.transpose(1, 2).reshape(b * VOCAB, t).contiguous()
    lens = torch.randint(t // 4, t + 1, (b,), generator=g)
    lens[0] = t
    mask = torch.arange(t)[None, :] < lens[:, None]
    r_nb = torch.randn(b, k, t, generator=g) * 5.0 - 40.0
    r_nb[:, ::2, : t // 8] = k8.LOG_ZERO
    r_b = torch.randn(b, k, t, generator=g) * 5.0 - 40.0
    token = torch.randint(4, VOCAB, (b, k), generator=g)
    last = torch.randint(4, VOCAB, (b, k), generator=g)
    last[:, ::3] = token[:, ::3]
    return [x.to(dev) for x in (flat, mask, r_nb, r_b, token, last)]


def _check_registers(what, got, want) -> float:
    """K8's registers against the plain version's: within ``K8_REL`` of
    max(1, |plain|) where the plain version reaches the cell, log-zero on
    both sides where it does not. Returns the largest abs error."""
    worst = 0.0
    for name, a, w in zip(("r_nb", "r_b"), got, want):
        reach = w > LOG_ZERO
        err = (a - w).abs()
        rel = (err / w.abs().clamp(min=1.0))[reach].max().item()
        unreached_ok = bool((a[~reach] <= LOG_ZERO).all())
        worst = max(worst, err[reach].max().item())
        print(f"{what} {name}: max_rel={rel:.3e} over {int(reach.sum())} reachable cells, "
              f"{int((~reach).sum())} log-zero on both sides: {unreached_ok}")
        require(rel <= K8_REL and unreached_ok, f"{what}: K8's {name} disagrees")
    return worst


# K8's shapes: the serving batch, 15 s, the bench decode's batch of 64 x 8 s
K8_SHAPES = ((8, 10, 288), (8, 10, 512), (64, 10, 267))


def check_ctc_prefix_kernel(dev) -> dict:
    """K8 vs ``ctc_selected_registers_reference`` at ``K8_SHAPES``, parents
    empty and not; times at each shape."""
    worst, timed = 0.0, []
    for b, k, t in K8_SHAPES:
        args = _k8_inputs(dev, b, k, t, seed=t)
        for empty in (True, False):
            got = k8.ctc_selected_registers(*args, empty)
            want = k8.ctc_selected_registers_reference(*args, empty)
            torch.cuda.synchronize()
            worst = max(worst, _check_registers(f"K8 {(b, k, t)} empty={empty}", got, want))
        limits = ctc_prefix_bound(b, k, t)
        # 5 samples a visit: the plain loop takes 30-80 ms a call
        times = turns_ms({
            "kernel": lambda: k8.ctc_selected_registers(*args, False),
            "plain": lambda: k8.ctc_selected_registers_reference(*args, False),
        }, n=5)
        _print_times("K8 ctc prefix registers", [b, k, t], times, limits, n=5)
        print(f"K8 {(b, k, t)}: no PyTorch call computes this recursion (library_ms null)")
        device = _wrapper_device_times("K8 ctc prefix registers", [b, k, t],
                                       lambda: k8.ctc_selected_registers(*args, False), limits)
        # the scan outruns its wrapper's host work: the kernel alone
        prof = _launch_device_ms(lambda: k8.ctc_selected_registers(*args, False),
                                 {"kernel": "ctc_prefix_registers_kernel"})
        print(f"K8 {(b, k, t)}: the kernel alone under the profiler {prof['kernel']:.4f} ms "
              f"({limits['bound_ms'] / prof['kernel'] * 100:.2f} % of the bound)")
        timed.append({**_measured([b, k, t], worst, times, limits), **device,
                      "profiler_ms": prof["kernel"]})
    return {**timed[0], "max_abs_err": worst, "other_shapes": timed[1:]}


@contextlib.contextmanager
def counted_steps(model, method="decode_step_lazy"):
    """Count the model's decode steps while the block runs: the joint and
    beam searches call ``decode_step_lazy`` once a step, or
    ``decode_step`` for a model without it (LAS)."""
    n = [0]
    inner = getattr(model, method)

    def step(*a, **kw):
        n[0] += 1
        return inner(*a, **kw)

    setattr(model, method, step)
    try:
        yield n
    finally:
        delattr(model, method)


def _first_batch(model, feat_cfg, manifest, dev, b=8):
    """Encoder output and lengths of the manifest's first decode batch."""
    _, wave, lengths = next(batched(read_manifest(manifest), b, 15 * 16000, 16000))
    with torch.inference_mode():
        feats, feat_lens = parse_batch(torch.from_numpy(wave).to(dev),
                                       torch.from_numpy(lengths).to(dev), feat_cfg)
        return model.encode(feats, feat_lens)


def _host_ctc_score(xs, ids, finished) -> float:
    """The float64 host oracle's CTC score of a hypothesis: its
    complete-sequence probability if it finished, else the prefix
    probability of its last extension."""
    if finished:
        return joint_mod.ctc_prefix_scores_host(xs, list(ids), [1])[3]
    return float(joint_mod.ctc_prefix_scores_host(xs, list(ids[:-1]), [ids[-1]])[0][0])


def check_joint_search(exp, corpus, dev) -> None:
    """The joint search on one batch of 8: kernel vs the plain recursion
    forced, ctc_weight 0 in f32 vs the attention beam, ctc_weight 1 vs the
    host oracle on 2 utterances."""
    model, _, feat_cfg, _ = load_experiment(exp, corpus["vocab"], "best", device=dev)
    enc, lens = _first_batch(model, feat_cfg, corpus["test"], dev)
    kw = dict(ctc_weight=0.3, ctc_prune=30)
    out = {}
    for route in ("kernel", "plain"):
        original = joint_mod.ctc_selected_registers
        if route == "plain":
            joint_mod.ctc_selected_registers = k8.ctc_selected_registers_reference
        try:
            with counted_steps(model) as n_steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = joint_mod.joint_beam_search(model, enc, lens, 10, 64, **kw).materialize()
                out[route] = (res, (time.perf_counter() - t0) * 1e3)
        finally:
            joint_mod.ctc_selected_registers = original
    (got, ms), (want, plain_ms) = out["kernel"], out["plain"]
    diff = float(np.abs(got.scores - want.scores).max())
    print(f"joint (batch of 8, {enc.shape[1]} frames, beam 10, ctc 0.3, prune 30): "
          f"{n_steps[0]} decode steps; search ms with K8 {ms:.1f}, with the plain recursion "
          f"{plain_ms:.1f}; tokens equal {np.array_equal(got.tokens, want.tokens)}, scores "
          f"max_abs={diff:.3e}")
    require(np.array_equal(got.tokens, want.tokens) and diff <= JOINT_SCORE_ABS,
            "joint search: the kernel and the plain recursion disagree")

    model32 = SpeechTransformer(flagship_config("float32"), VOCAB,
                                torch.Generator().manual_seed(0)).to(dev).eval()
    enc32, lens32 = _first_batch(model32, FeatureConfig(fbank_impl="pallas"), corpus["test"],
                                 dev)
    beam = beam_search(model32, enc32, lens32, 10, 64).materialize()
    j0 = joint_mod.joint_beam_search(model32, enc32, lens32, 10, 64, ctc_weight=0.0,
                                     ctc_prune=VOCAB).materialize()
    s_diff = float(np.abs(beam.scores - j0.scores).max())
    print(f"joint f32 ctc_weight 0, prune {VOCAB} vs beam: tokens equal "
          f"{np.array_equal(beam.tokens, j0.tokens)}, scores max_abs={s_diff:.3e}")
    require(np.array_equal(beam.tokens, j0.tokens), "joint at ctc_weight 0 != beam")
    del model32

    j1 = joint_mod.joint_beam_search(model, enc[:2], lens[:2], 10, 64, ctc_weight=1.0,
                                     ctc_prune=30).materialize()
    with torch.inference_mode():
        lp = model.ctc_log_probs(enc[:2]).double().cpu().numpy()
    for b, ids in enumerate(j1.nbest_ids(1)):
        xs = lp[b, : int(lens[b])]
        want_sc = _host_ctc_score(xs, ids[0], bool(j1.finished[b, 0]))
        err = abs(float(j1.scores[b, 0]) - want_sc)
        print(f"joint ctc_weight 1, utterance {b}: {len(ids[0])} tokens, finished "
              f"{bool(j1.finished[b, 0])}, score {float(j1.scores[b, 0]):.4f} vs host oracle "
              f"{want_sc:.4f} (abs {err:.3e})")
        require(err <= ORACLE_REL * max(1.0, abs(want_sc)), "joint score != host oracle")


K9_REL = 1e-5  # K9's scores: of max(1, |plain|); prefixes and lengths identical
K9_ARGS = dict(beam_size=10, prune=8, max_prefix_len=64)  # what ``recognize`` sends


def ctc_prefix_beam_bound(lens, t, c, k, p, l) -> dict:
    """K9 on utterances of ``lens`` frames (of T = ``t``): the rows t < len
    of the log-probs read once (the search uses no frame past an
    utterance's length) and the lengths; the prefixes, their lengths and the
    scores written. Operations, f32, per frame an utterance has: one
    comparison a class for the frame's top P, K x K comparisons of up to L
    tokens for the duplicate merge, and ten a candidate for the K (P + 1)
    candidates' scores and selection (more than this run's data needs: the
    bound is the bytes' by far)."""
    b = len(lens)
    frames = float(sum(min(int(n), t) for n in lens))
    n_bytes = 4.0 * frames * c + 8.0 * b + 8.0 * b * k * l + 12.0 * b * k
    flops = frames * (c + k * k * l + 10 * k * (p + 1))
    return bound(n_bytes, flops, H100_SXM_F32_PEAK)


def _peaky_rows(dev, b, t, seed, ties=False) -> tuple:
    """(B, T, C) f32 log-probs of the flagship's vocabulary on the card and
    ragged lengths (the first full). ``ties``: logits on a grid of four
    levels (most classes tie with many others), the blank at the top level
    on every third frame, and every fifth frame one value throughout."""
    g = torch.Generator().manual_seed(seed)
    if ties:
        logits = torch.randint(0, 4, (b, t, VOCAB), generator=g).float() * 1.5
        logits[:, ::3, 0] = 4.5
        logits[:, ::5] = 0.0
    else:
        logits = torch.randn(b, t, VOCAB, generator=g) * 3.0
    lens = torch.randint(t // 4, t + 1, (b,), generator=g)
    lens[0] = t
    return torch.log_softmax(logits, dim=-1).to(dev), lens.to(dev)


def _check_prefix_beam(what, lp, lens, args=K9_ARGS) -> float:
    """K9 against its plain version on the same inputs: identical prefixes
    and lengths, scores within ``K9_REL`` of max(1, |plain|), one wrapper
    launch. Returns the largest abs score difference."""
    before = k9.ctc_prefix_beam_kernel.launches
    got = ctc_prefix_beam_device(lp, lens, **args)
    calls = k9.ctc_prefix_beam_kernel.launches - before
    want = ctc_prefix_beam_reference(lp, lens, **args)
    torch.cuda.synchronize()
    same_pref = bool(torch.equal(got[0], want[0]))
    same_len = bool(torch.equal(got[1], want[1]))
    err = (got[2] - want[2]).abs()
    rel = (err / want[2].abs().clamp(min=1.0)).max().item()
    print(f"K9 {what} {tuple(lp.shape)} beam {args['beam_size']} prune {args['prune']} L "
          f"{args['max_prefix_len']} lengths {lens.tolist()}: prefixes equal {same_pref}, "
          f"lengths equal {same_len}, scores max_abs={err.max().item():.3e} max_rel={rel:.3e}, "
          f"{calls} wrapper launch; best {got[1][:, 0].tolist()} tokens long")
    if not (same_pref and same_len):
        rows = (got[0] != want[0]).flatten(1).any(1) | (got[1] != want[1]).any(1)
        for b in rows.nonzero().flatten().tolist():
            print(f"K9 {what} utterance {b}: kernel lengths {got[1][b].tolist()} scores "
                  f"{got[2][b].tolist()}; plain {want[1][b].tolist()} {want[2][b].tolist()}")
    require(same_pref and same_len and rel <= K9_REL, f"K9 {what}: disagrees with plain")
    require(calls == 1, f"K9 {what}: {calls} wrapper launches in one call")
    return err.max().item()


def check_ctc_prefix_beam_kernel(exp, corpus, dev) -> dict:
    """K9 vs ``ctc_prefix_beam_reference`` at beam 10, prune 8, L 64: on the
    flagship's CTC log-probs of phase 8's first serving batch (its ragged
    lengths), on synthetic peaky rows and on rows with planted ties at (8,
    288), and at 15 s (8, 512); at its limits, beam 32, prune 32, L 128 at
    (4, 288), and peaky rows at L 8 (8, 288), whose prefixes reach L; times
    at the serving batch and at 15 s, the wall time of one call, its
    launches by the counter and its kernels under the profiler."""
    model, _, feat_cfg, _ = load_experiment(exp, corpus["vocab"], "best", device=dev)
    enc, lens = _first_batch(model, feat_cfg, corpus["test"], dev)
    with torch.inference_mode():
        lp = model.ctc_log_probs(enc).float()
    del model
    inputs = {"flagship": (lp, lens), "peaky": _peaky_rows(dev, 8, 288, seed=1),
              "ties": _peaky_rows(dev, 8, 288, seed=2, ties=True),
              "15 s": _peaky_rows(dev, 8, 512, seed=3)}
    at_limits = {"beam 32": (*_peaky_rows(dev, 4, 288, seed=4),
                             dict(beam_size=32, prune=32, max_prefix_len=128)),
                 "L 8": (*_peaky_rows(dev, 8, 288, seed=5), {**K9_ARGS, "max_prefix_len": 8})}
    worst = max(_check_prefix_beam(what, *args)
                for what, args in {**inputs, **at_limits}.items())
    timed = []
    for what in ("flagship", "15 s"):
        x, n = inputs[what]
        b, t, c = x.shape
        limits = ctc_prefix_beam_bound(n.tolist(), t, c, K9_ARGS["beam_size"],
                                       K9_ARGS["prune"], K9_ARGS["max_prefix_len"])
        # the plain loop takes 0.3-1.5 s a call: 2 samples a visit
        times = turns_ms({
            "kernel": lambda: ctc_prefix_beam_device(x, n, **K9_ARGS),
            "plain": lambda: ctc_prefix_beam_reference(x, n, **K9_ARGS),
        }, n=2, warmup=1)
        _print_times("K9 ctc prefix beam", [b, t, c], times, limits, n=2)
        print(f"K9 {(b, t, c)}: no PyTorch call runs this search (library_ms null)")
        device = _wrapper_device_times("K9 ctc prefix beam", [b, t, c],
                                       lambda: ctc_prefix_beam_device(x, n, **K9_ARGS),
                                       limits)
        parts = _launch_device_ms(lambda: ctc_prefix_beam_device(x, n, **K9_ARGS), {
            "rows": "prefix_beam_rows_kernel", "recursion": "prefix_beam_recursion_kernel"})
        before = k9.ctc_prefix_beam_kernel.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctc_prefix_beam_device(x, n, **K9_ARGS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        calls = k9.ctc_prefix_beam_kernel.launches - before
        print(f"K9 {(b, t, c)}: row pass {parts['rows']:.4f} ms + recursion "
              f"{parts['recursion']:.4f} ms under the profiler; one call {wall:.3f} ms wall, "
              f"{calls} wrapper launch, {len(parts)} kernels ({', '.join(parts)})")
        require(calls == 1, f"K9: {calls} wrapper launches in one call")
        timed.append({**_measured([b, t, c], worst, times, limits), **device,
                      "profiler_ms": parts})
    return {**timed[0], "max_abs_err": worst, "other_shapes": timed[1:]}


def run_decoding_modes(exp, corpus, dev) -> tuple:
    """K8 and K9 against their plain versions, every ``recognize`` mode on
    phase 8's experiment and corpus (16 utterances, batches of 8, beam 10),
    then the joint search's checks. Returns the joint run's launch counts,
    its batch count, and K8's and K9's times with the decode steps of that
    run and the device rescore run's launch counts and batch count."""
    k8_times = check_ctc_prefix_kernel(dev)
    k9_times = check_ctc_prefix_beam_kernel(exp, corpus, dev)
    # the model ``recognize`` memoizes, so its decode steps can be counted
    model, *_ = _load_experiment_cached(exp, corpus["vocab"], "best", torch.device("cuda"))
    joint_counts, joint_batches, joint_steps, rescore = None, 0, 0, None
    for name, kw in DECODE_MODES.items():
        mode = kw.get("mode", name)
        with counted_steps(model) as n_steps:
            reset_counters()
            t0 = time.perf_counter()
            res = recognize(exp, corpus["vocab"], manifest=corpus["test"], mode=mode,
                            beam_size=10, batch_size=8, max_decode_len=64, device="cuda",
                            **{k: v for k, v in kw.items() if k != "mode"})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counters()
        tm = res["timing"]
        n = tm["batches"]
        utts = res["utts"]
        require(len(utts) == 16, f"{name}: {len(utts)} of 16 decoded")
        for utt, entry in utts.items():
            require(len(entry["output"]) >= 1, f"{name} {utt}: no hypothesis")
            if mode in ("beam", "joint", "attention_greedy"):
                require(all(np.isfinite(o["score"]) for o in entry["output"]),
                        f"{name} {utt}: score not finite")
        require(counts["fbank"] == n and counts["fused_attention_fwd"] == 6 * n,
                f"{name}: launches {counts} for {n} batches")
        want_k8 = n_steps[0] if mode == "joint" else 0
        require(counts["ctc_prefix"] == want_k8,
                f"{name}: K8 launches {counts['ctc_prefix']} != {want_k8} decode steps")
        # K9: the device prefix beam once per rescore batch, the plain loop never
        want_k9 = n if name == "rescore-device" else 0
        require(counts["ctc_prefix_beam"] == want_k9,
                f"{name}: K9 launches {counts['ctc_prefix_beam']} != {want_k9}")
        if mode == "joint":
            joint_counts, joint_batches, joint_steps = counts, n, n_steps[0]
        if name == "rescore-device":
            rescore = (counts, n)
        print(f"recognize {name}: {n} batches, {tm['audio_s']:.3f} s audio; per batch of 8 "
              f"encode {tm['encode_s'] / n * 1e3:.3f} ms, search {tm['search_s'] / n * 1e3:.3f} "
              f"ms; audio-s/s {tm['audio_s'] / (tm['encode_s'] + tm['search_s']):.3f} "
              f"(encode+search), {tm['audio_s'] / wall:.3f} (wall); K8 launches "
              f"{counts['ctc_prefix']} over {n_steps[0]} decode steps, K9 launches "
              f"{counts['ctc_prefix_beam']}")
    check_joint_search(exp, corpus, dev)
    return joint_counts, joint_batches, {"k8": k8_times, "k9": k9_times,
                                         "steps_run": joint_steps, "rescore": rescore}


# -- phase 9b: decoded CER in evaluation ---------------------------------------


def check_eval_decode(exp_dir, corpus, dev) -> None:
    """``Trainer.evaluate`` on phase 9's best checkpoint in each
    ``eval_decode`` mode: a finite ``dev/decoded_cer``."""
    base = Config.load(os.path.join(exp_dir, "config.json"))
    vocab = Vocab.load(corpus["vocab"])
    blob = torch.load(checkpoint_path(exp_dir, "best"), map_location="cpu",
                      weights_only=True)
    loader = BucketedLoader(
        corpus["dev"], vocab, batch_size=base.batch_size, max_target_len=base.max_target_len,
        shuffle=False, use_native_io=False, wire_dtype="int16", drop_last=False,
    )
    for mode in ("ctc_greedy", "attention_greedy", "beam", "joint"):
        cfg = Config(**{**base.to_dict(), "eval_decode": mode, "eval_beam_size": 10,
                        "exp_root": os.path.join(WORK, "eval_decode"), "exp_name": mode})
        model = SpeechTransformer(cfg, vocab.vocab_size)
        model.load_state_dict(blob["state_dict"])
        model = model.to(dev)
        trainer = Trainer(model, make_optimizer(model.parameters(), cfg, cfg.d_model), cfg,
                          feature_config_from(cfg), vocab, train_loader=loader,
                          dev_loader=loader)
        trainer.state = trainer.init_fn()
        t0 = time.perf_counter()
        trainer.evaluate(loader, "dev/")
        torch.cuda.synchronize()
        with open(os.path.join(trainer.exp_dir, "scalars.jsonl")) as f:
            row = [json.loads(line) for line in f][-1]
        cer = row.get("dev/decoded_cer")
        print(f"eval_decode {mode}: dev/decoded_cer {cer} (teacher-forced cer "
              f"{row['dev/cer']:.2f}), evaluate {time.perf_counter() - t0:.3f} s")
        require(cer is not None and np.isfinite(cer), f"eval_decode {mode}: no decoded_cer")
        del trainer, model


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


def train_launches(steps: int, n_eval: int, window: bool = False) -> dict:
    """The launches a ``main.train`` run must make: per train step K5 1,
    six attention forwards and backwards (K1/K2, or K6/K7 on the window),
    K3 1, K4 1; per dev batch K5 1, six forwards and K3 1."""
    fwd, bwd = (("banded_attention_fwd", "banded_attention_bwd") if window
                else ("fused_attention_fwd", "fused_attention_bwd"))
    want = {k: 0 for k in COUNTERS}
    want.update({
        "fbank": steps + n_eval, fwd: 6 * (steps + n_eval), bwd: 6 * steps,
        "ctc_alpha": steps + n_eval, "ctc_beta": steps,
    })
    return want


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
    want = train_launches(steps, n_eval)
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
    return counts, corpus, exp_dir


# -- phase 10: one f32 step, card vs CPU ----------------------------------------


def _recipe(dtype: str, **overrides) -> tuple:
    """(model config, train config, feature config) of the flagship recipe,
    or with ``model_name`` one of the RNN family, of its registry config
    (its widths, rng dropout 0.1, its CTC weight) through the same fbank and
    CTC kernels."""
    if overrides.get("model_name") in RNN_NAMES:
        cfg = get_model(overrides["model_name"])[1]().build(
            dtype=dtype, fbank_impl="pallas", **{"ctc_impl": "pallas", **overrides})
        cfg = Config(**cfg.to_dict())
    else:
        cfg = flagship_config(dtype).build(**{"dropout_impl": "hash", "ctc_impl": "pallas",
                                              **overrides})
    return cfg, default_train_config().combine(cfg), FeatureConfig(fbank_impl="pallas")


def build_model(cfg, device):
    """The registry's model for ``cfg`` (the flagship's SpeechTransformer
    when it names none), weights from seed 0, on ``device``."""
    model_cls = get_model(cfg.get("model_name", "SpeechTransformer"))[0]
    return model_cls(cfg, VOCAB, torch.Generator().manual_seed(0)).to(device)


def _one_step(cfg, tcfg, feat, batch, device):
    """(loss, gradient norm, {parameter: its gradient on the CPU, as before
    clipping}) of one train step from seed-0 weights."""
    model = build_model(cfg, device)
    opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    state, m = train_step(init_fn(), *(x.to(device) for x in batch), 0)
    norm = float(m["grad_norm"])
    unclip = max(1.0, norm / float(tcfg.grad_clip))
    grads = {name: p.grad.detach().cpu() * unclip for name, p in model.named_parameters()
             if p.grad is not None}
    return float(m["loss"]), norm, grads


def check_step_against_cpu(corpus, dev, label="flagship", worst_grads=0, grad_rel=None,
                           **overrides) -> None:
    """One f32 step of the recipe (``overrides``: model config) on the card
    and on the CPU's plain path: loss and gradient norm within 1e-3
    relative; with ``worst_grads`` the parameters whose gradients differ
    most, card against CPU, and by how much; with ``grad_rel`` every
    parameter's gradient within it relative (|diff_p| / |g_p|), but the key
    projections' biases, whose gradient is zero in exact arithmetic (a
    softmax does not see a shift of its row) and so all rounding."""
    cfg, tcfg, feat = _recipe("float32", dropout_rate=0.0, **overrides)
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
    *cpu, cpu_grads = _one_step(cfg, tcfg, feat, batch, torch.device("cpu"))
    *card, card_grads = _one_step(cfg, tcfg, feat, batch, dev)
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"{label} f32 step, card vs cpu: loss {card[0]:.6f} vs {cpu[0]:.6f} (rel "
          f"{rel[0]:.2e}), grad_norm {card[1]:.6f} vs {cpu[1]:.6f} (rel {rel[1]:.2e})")
    if worst_grads:
        # each parameter's share of the gradient difference, card against
        # CPU (|diff_p| / |diff|), beside its own |diff_p| / |g_p|: a
        # gradient that is zero in exact arithmetic (a key projection's
        # bias) is all rounding, so its own ratio alone says nothing
        diff = {k: card_grads[k] - g for k, g in cpu_grads.items()}
        total = max(float(torch.sqrt(sum(d.square().sum() for d in diff.values()))), 1e-30)
        ranked = sorted(diff, key=lambda k: -float(diff[k].norm()))[:worst_grads]
        print(f"{label} f32 step, gradient difference card vs cpu |diff| {total:.4e} "
              f"(|g| {card[1]:.4e}); largest parameters: " + ", ".join(
                  f"{k} share {float(diff[k].norm()) / total:.3f} own "
                  f"{float(diff[k].norm() / cpu_grads[k].norm().clamp_min(1e-30)):.2e}"
                  for k in ranked))
    require(max(rel) <= 1e-3, f"{label} f32 train step on the card disagrees with the CPU")
    if grad_rel is not None:
        own = {k: float((card_grads[k] - g).norm() / g.norm().clamp_min(1e-30))
               for k, g in cpu_grads.items() if not k.endswith("k_proj.bias")}
        worst = max(own, key=own.get)
        print(f"{label} f32 step, per-parameter gradient card vs cpu: largest |diff_p| / |g_p| "
              f"{own[worst]:.3e} ({worst}) over {len(own)} parameters (bound {grad_rel:.0e})")
        require(own[worst] <= grad_rel,
                f"{label} f32 gradient of {worst} on the card disagrees with the CPU's")


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


def run_streaming_training(corpus, num_epoch=2, exp_name="streaming",
                           **overrides) -> tuple[dict, str]:
    """``main.train`` with the streaming recipe (``overrides``: its model
    config) through K6/K7; returns the launch counts and the experiment
    directory."""
    exp_root = os.path.join(WORK, "stream_exp")
    shutil.rmtree(os.path.join(exp_root, exp_name), ignore_errors=True)
    kw = dict(
        STREAMING_RECIPE, vocab_path=corpus["vocab"], train_manifest=corpus["train"],
        dev_manifest=corpus["dev"], test_manifest=None, batch_size=64,
        num_epoch=num_epoch, log_every_iter=1, eval_every_iter=0, save_every_iter=0,
        device="cuda", use_native_io=False, exp_root=exp_root, exp_name=exp_name,
        seed=0, **overrides,
    )
    with banded_window("1"):
        reset_counters()
        t0 = time.perf_counter()
        trainer = main_train(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
    steps = trainer.state.step
    n_eval = num_epoch * len(trainer.dev_loader)
    print(f"{exp_name} train: {steps} steps in {num_epoch} epochs, {n_eval} dev batches, "
          f"wall {wall:.3f} s; launches {counts}")
    require(steps == 2 * num_epoch, f"{exp_name} train ran {steps} steps, want "
            f"{2 * num_epoch}")
    want = train_launches(steps, n_eval, window=True)
    require(counts == want, f"{exp_name} training launches {counts} != {want}")
    rows = _logged_losses(trainer.exp_dir)
    require(len(rows) == steps and all(np.isfinite(r["train/loss"]) for r in rows),
            f"{exp_name} train: missing or non-finite losses")
    for r in rows:
        print(f"{exp_name} train step {r['step']}: loss {r['train/loss']:.4f} ctc "
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


def run_streaming_serving(exp_dir: str, vocab_path: str, dev, n_streams=4,
                          dtypes=("bfloat16", "float32"),
                          modes=("ctc_greedy", "beam", "joint")) -> dict:
    """The streaming checkpoint served on ``n_streams`` streams in both
    encode modes, each final mode of ``modes`` and each dtype of
    ``dtypes``; returns the launch counts of the first dtype's runs."""
    model, cfg, feat_cfg, vocab = load_experiment(exp_dir, vocab_path, "best", device=dev)
    blob = torch.load(checkpoint_path(exp_dir, "best"), map_location="cpu",
                      weights_only=True)
    model32 = SpeechTransformer(Config(**{**cfg.to_dict(), "dtype": "float32"}),
                                vocab.vocab_size)
    model32.load_state_dict(blob["state_dict"])
    model32 = model32.to(dev).eval()
    streams = make_streams()[:n_streams]
    models = {"bfloat16": model, "float32": model32}
    print(f"streaming serving: {len(streams)} streams of "
          f"{', '.join(f'{len(x) / 16000:.3f}' for x in streams)} s")
    launches = {k: 0 for k in COUNTERS}
    finals = {}
    for dtype in dtypes:
        m = models[dtype]
        for mode in modes:
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
                with banded_window("1"), counted_steps(m) as n_steps:
                    reset_counters()
                    # joint finals on the first 2 streams: they cost as
                    # much as beam finals, and the phase's time is bounded
                    out, t_p, t_f, segs = serve_streams(
                        rec, streams[:2] if mode == "joint" else streams)
                    counts = read_counters()
                n = n_encodes[0]
                # K8: one launch per decode step of a joint final
                want = {k: 0 for k in COUNTERS}
                want["ctc_prefix"] = n_steps[0] if mode == "joint" else 0
                if dtype == dtypes[0]:
                    launches = {k: launches[k] + counts[k] for k in COUNTERS}
                if inc == "off":
                    want.update(fbank=n, banded_attention_fwd=6 * n)
                else:
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
    for dtype in dtypes:
        for mode in modes:
            a, b = finals[dtype, mode, "on"], finals[dtype, mode, "off"]
            require([x[1:] for x in a] == [x[1:] for x in b], "final segment bounds differ")
            same = sum(x[0] == y[0] for x, y in zip(a, b))
            print(f"stream {dtype} {mode}: {same} of {len(a)} incremental finals equal "
                  f"the prefix re-encode finals; first: {a[0][0][:40]!r}")
            if dtype == "float32":
                require(same == len(a), f"f32 {mode}: incremental finals differ")
    require(len(finals[dtypes[0], "ctc_greedy", "off"]) == 3 * len(streams),
            "want 3 finals per stream")
    return launches


# -- phase 13: throughput ------------------------------------------------------


THROUGHPUT_BATCH, THROUGHPUT_SECONDS, THROUGHPUT_LABEL_LEN = 64, 8.0, 20


def fixed_batch(dev, bsz) -> list:
    """(waves, lengths, labels, label lengths) of ``bsz`` random 8 s
    utterances with label length 20, on ``dev``."""
    samples = int(THROUGHPUT_SECONDS * 16000)
    rng = np.random.RandomState(0)
    batch = [
        torch.from_numpy((rng.randn(bsz, samples) * 0.1 * 32767).astype(np.int16)),
        torch.full((bsz,), samples, dtype=torch.int32),
        torch.from_numpy(rng.randint(4, VOCAB, size=(bsz, THROUGHPUT_LABEL_LEN))
                         .astype(np.int32)),
        torch.full((bsz,), THROUGHPUT_LABEL_LEN, dtype=torch.int32),
    ]
    return [x.to(dev) for x in batch]


def flagship_train_setup(dev, dtype="bfloat16", feat_overrides=None, **overrides) -> tuple:
    """(train_step, state, batch, flops per step) of the flagship recipe
    (bf16, hash dropout 0.1, SpecAugment, CTC 0.3 through the kernels;
    ``overrides``: model config, e.g. the conformer's or an RNN model's
    ``model_name``; ``feat_overrides``: feature config, e.g. a time warp)
    on one fixed batch of 64 x 8 s with label length 20, as ``bench.py``."""
    cfg, tcfg, feat = _recipe(dtype, **overrides)
    feat = dataclasses.replace(feat, **(feat_overrides or {}))
    tcfg.build(spec_augment=True)
    bsz, label_len = THROUGHPUT_BATCH, THROUGHPUT_LABEL_LEN
    samples = int(THROUGHPUT_SECONDS * feat.sample_rate)
    batch = fixed_batch(dev, bsz)
    model = build_model(cfg, dev)
    opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    flops = analytic_train_flops(cfg, feat, VOCAB, bsz, samples, label_len)
    return train_step, init_fn(), batch, flops


def _step_device_ms(train_step, state, batch, n=3) -> float:
    """Device ms per step over ``n`` steps under ``torch.profiler``: the
    self device time of the device's own events (kernels, copies), summed;
    a host operator's device time is that of the kernels it launched."""
    from torch.autograd import DeviceType

    with _traced() as prof:
        for _ in range(n):
            state, _ = train_step(state, *batch, 0)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type != DeviceType.CPU and WARMUP_KERNEL not in e.key) / n / 1e3


def measure_training_throughput(dev, n_warmup=3, n_timed=20, label="flagship",
                                dtype="bfloat16", device_steps=0, **overrides) -> dict:
    """``n_timed`` steps of ``flagship_train_setup``'s recipe after
    ``n_warmup``: ms per step, audio-s/s, MFU against the dtype's peak (the
    tensor cores' bf16, or f32 outside them), the launches per step, and
    with ``device_steps`` the device ms per step under the profiler."""
    train_step, state, batch, flops = flagship_train_setup(dev, dtype, **overrides)
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
    if overrides.get("model_name") in RNN_NAMES:
        want = {k: 0 for k in COUNTERS}
        want.update(fbank=n_timed, ctc_alpha=n_timed, ctc_beta=n_timed)
        require(counts == want, f"{label} throughput launches {counts} != {want}")
    else:
        require(counts["fused_attention_bwd"] == 6 * n_timed and counts["ctc_beta"] == n_timed,
                f"throughput loop launches {counts}")
    peak = bench.peak_flops(dtype)
    out = {
        "launches_per_step": {k: v / n_timed for k, v in counts.items()},
        "ms_per_step": step_s * 1e3,
        "steps_per_s": 1.0 / step_s,
        "audio_s_per_s": bsz * seconds / step_s,
        "tflop_per_step": flops / 1e12,
        "mfu": flops / step_s / peak,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    device = ""
    if device_steps:
        out["device_ms_per_step"] = _step_device_ms(train_step, state, batch, device_steps)
        device = (f", device {out['device_ms_per_step']:.3f} ms/step "
                  f"({out['device_ms_per_step'] / out['ms_per_step'] * 100:.1f} % busy, "
                  f"{device_steps} profiled steps)")
    short = "bf16" if dtype == "bfloat16" else "f32"
    print(f"train throughput, {label} {short}, batch 64 x 8 s, {n_timed} steps after "
          f"{n_warmup} warm-up: {out['ms_per_step']:.3f} ms/step, "
          f"{out['steps_per_s']:.4f} steps/s, {out['audio_s_per_s']:.1f} audio-s/s, "
          f"{out['tflop_per_step']:.4f} TFLOP/step, MFU {out['mfu'] * 100:.3f} % of "
          f"{peak / 1e12:.1f} TFLOP/s {short}, peak memory "
          f"{out['peak_mem_gib']:.2f} GiB, final loss {float(m['loss']):.4f}{device}")
    return out


def flagship_step_launches() -> dict:
    """The launches of one flagship train step (and of one step of each
    recipe that shares its kernels)."""
    want = {k: 0.0 for k in COUNTERS}
    want.update(fbank=1.0, fused_attention_fwd=6.0, fused_attention_bwd=6.0, ctc_alpha=1.0,
                ctc_beta=1.0)
    return want


def require_positive(what: str, result: dict, keys) -> None:
    """Each of ``keys`` in ``result`` a finite positive number."""
    bad = {k: result.get(k) for k in keys
           if not (isinstance(result.get(k), (int, float)) and math.isfinite(result[k])
                   and result[k] > 0)}
    require(not bad, f"{what}: not finite and positive: {bad}")


def measure_flagship_throughput(dev, n_steps=20) -> dict:
    """Phase 13: ``asr_chinese_e2e_tpu_torch.bench.main`` (the flagship
    recipe on the JAX bench's fixed batch of 64 x 8 s: a first step, 2
    warm-up steps, ``n_steps`` timed); its line, the launches per step of
    all its steps, MFU against the bf16 peak."""
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    r = bench.main(n_steps=n_steps, _return_result=True)
    per_step = {k: v / (n_steps + 3) for k, v in read_counters().items()}
    require(per_step == flagship_step_launches(),
            f"bench.main launches per step {per_step}")
    require_positive("bench.main", r, ("value", "steps_per_s", "flops_per_step", "mfu"))
    ms = 1e3 / r["steps_per_s"]
    print(f"train throughput, flagship bf16 (bench.main), batch 64 x 8 s, {n_steps} steps "
          f"after 3: {ms:.3f} ms/step, {r['steps_per_s']:.4f} steps/s, {r['value']:.1f} "
          f"audio-s/s, {r['flops_per_step'] / 1e12:.4f} TFLOP/step, MFU {r['mfu'] * 100:.3f} % "
          f"of {H100_SXM_BF16_PEAK / 1e12:.1f} TFLOP/s bf16, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"bench.main: {json.dumps(r)}")
    return {"launches_per_step": per_step, "ms_per_step": ms}


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
    batch = fixed_batch(dev, THROUGHPUT_BATCH)
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    return train_step, init_fn(), batch


STREAMING_ROUTES = {"1": "windowed K6/K7", "0": "full-tile K1/K2"}


def measure_streaming_throughput(dev, n_warmup=3, n_pairs=5, n_segment=4) -> dict:
    """The streaming recipe's step on one fixed batch of 64 x 8 s, one model
    and optimizer state, with the window on (K6/K7) and off (K1/K2) in
    alternating pairs of segments of ``n_segment`` timed steps (the route
    is read at each attention call), the order swapped from pair to pair so
    that a drift of the host falls on both routes alike; returns the
    launches per step of the windowed route."""
    train_step, state, batch = streaming_train_setup(dev)
    for window in STREAMING_ROUTES:
        with banded_window(window):
            for _ in range(n_warmup):
                state, m = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    segments = {window: [] for window in STREAMING_ROUTES}
    counts = {window: {k: 0 for k in COUNTERS} for window in STREAMING_ROUTES}
    for pair in range(n_pairs):
        for window in ("1", "0") if pair % 2 == 0 else ("0", "1"):
            with banded_window(window):
                reset_counters()
                t0 = time.perf_counter()
                for _ in range(n_segment):
                    state, m = train_step(state, *batch, 0)
                torch.cuda.synchronize()
                segments[window].append((time.perf_counter() - t0) / n_segment * 1e3)
                for k, v in read_counters().items():
                    counts[window][k] += v
    n_timed = n_pairs * n_segment
    require(np.isfinite(float(m["loss"])), "streaming throughput loss not finite")
    for window, (fwd, bwd) in (("1", ("banded_attention_fwd", "banded_attention_bwd")),
                               ("0", ("fused_attention_fwd", "fused_attention_bwd"))):
        c = counts[window]
        require(c[fwd] == 6 * n_timed and c[bwd] == 6 * n_timed
                and sum(c[k] for k in COUNTERS if "attention" in k) == 12 * n_timed,
                f"streaming throughput launches, {STREAMING_ROUTES[window]}: {c}")
        ms = statistics.median(segments[window])
        print(f"streaming train throughput, {STREAMING_ROUTES[window]}, bf16, batch 64 x 8 s, "
              f"{n_pairs} segments of {n_segment} steps after {n_warmup} warm-up, ms/step: "
              f"{', '.join(f'{x:.3f}' for x in segments[window])}; median {ms:.3f} ms/step, "
              f"{1e3 / ms:.4f} steps/s, "
              f"{THROUGHPUT_BATCH * THROUGHPUT_SECONDS * 1e3 / ms:.1f} audio-s/s")
    won = sum(w < f for w, f in zip(segments["1"], segments["0"]))
    print(f"streaming train throughput: the window won {won} of {n_pairs} alternating pairs "
          f"(final loss {float(m['loss']):.4f})")
    return {k: v / n_timed for k, v in counts["1"].items()}


# -- phase 14b: the conformer family ----------------------------------------------

# the registry's Conformer: conformer blocks (conv kernel 15), pre-LN
CONFORMER = dict(encoder_type="conformer", norm_type="pre")


@contextlib.contextmanager
def attention_query_rows():
    """The query rows (Tq) of every fused attention call the model's
    layers make while the block runs."""
    rows = []
    inner = layers_mod.fused_attention_general

    def probe(q, *args):
        rows.append(q.shape[2])
        return inner(q, *args)

    layers_mod.fused_attention_general = probe
    try:
        yield rows
    finally:
        layers_mod.fused_attention_general = inner


def _train_conformer(corpus) -> tuple:
    """``main.train --model_name Conformer`` with the flagship recipe on
    phase 9's corpus, 1 epoch; returns (launch counts, experiment dir)."""
    exp_root = os.path.join(WORK, "conformer_exp")
    shutil.rmtree(exp_root, ignore_errors=True)
    reset_counters()
    t0 = time.perf_counter()
    trainer = main_train(**training_kwargs(corpus, exp_root, model_name="Conformer",
                                           exp_name="conformer", num_epoch=1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    cfg = trainer.model.cfg
    require(cfg.encoder_type == "conformer" and cfg.conv_kernel_size == 15
            and cfg.d_model == 512, "main.train did not build the registry's Conformer")
    steps, n_eval = trainer.state.step, len(trainer.dev_loader)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"conformer train: d_model 512, 8 heads, 6 conformer blocks (conv 15) + 6 "
          f"decoder layers, {n_params} parameters; {steps} steps in 1 epoch, {n_eval} dev "
          f"batches, wall {wall:.3f} s; launches {counts}")
    require(steps == 2, f"conformer train ran {steps} steps, want 2")
    want = train_launches(steps, n_eval)
    require(counts == want, f"conformer training launches {counts} != {want}")
    rows = _logged_losses(trainer.exp_dir)
    require(len(rows) == steps and all(np.isfinite(r["train/loss"]) for r in rows),
            "conformer train: missing or non-finite losses")
    for r in rows:
        print(f"conformer train step {r['step']}: loss {r['train/loss']:.4f} ctc "
              f"{r['train/ctc_loss']:.4f} ce {r['train/ce_loss']:.4f} grad_norm "
              f"{r['train/grad_norm']:.4f}")
    exp_dir = trainer.exp_dir
    del trainer
    torch.cuda.empty_cache()
    return counts, exp_dir


def _serve_conformer(exp_dir, corpus) -> tuple:
    """The trained conformer through ``recognize`` in ``beam`` and
    ``joint``; returns the two runs' launch counts summed and the number of
    batches each ran."""
    model, *_ = _load_experiment_cached(exp_dir, corpus["vocab"], "best",
                                        torch.device("cuda"))
    total = {k: 0 for k in COUNTERS}
    for mode in ("beam", "joint"):
        with counted_steps(model) as n_steps:
            reset_counters()
            res = recognize(exp_dir, corpus["vocab"], manifest=corpus["dev"], mode=mode,
                            beam_size=10, batch_size=8, max_decode_len=32, device="cuda",
                            out=os.path.join(WORK, f"conformer_{mode}.json"))
            torch.cuda.synchronize()
            counts = read_counters()
        n, tm = res["timing"]["batches"], res["timing"]
        require(len(res["utts"]) == 16, f"conformer {mode}: {len(res['utts'])} of 16")
        for utt, entry in res["utts"].items():
            require(entry["output"] and all(np.isfinite(o["score"]) for o in entry["output"]),
                    f"conformer {mode} {utt}: no finite hypothesis")
        want = {k: 0 for k in COUNTERS}
        want.update(fbank=n, fused_attention_fwd=6 * n,
                    ctc_prefix=n_steps[0] if mode == "joint" else 0)
        require(counts == want, f"conformer {mode}: launches {counts} != {want}")
        total = {k: total[k] + counts[k] for k in COUNTERS}
        print(f"conformer recognize {mode}: {n} batches, {tm['audio_s']:.3f} s audio; per "
              f"batch of 8 encode {tm['encode_s'] / n * 1e3:.3f} ms, search "
              f"{tm['search_s'] / n * 1e3:.3f} ms; CER {res['cer']:.2f}%; launches {counts}")
    return total, n


def _conv2d_conformer(dev) -> None:
    """A conformer with the conv2d frontend, flagship recipe: one train step
    and one beam decode on 8 x 8 s; K1 sees ceil(ceil(T/2)/2) frames."""
    cfg, tcfg, feat = _recipe("bfloat16", frontend="conv2d", **CONFORMER)
    tcfg.build(spec_augment=True)
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(dev)
    opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    batch = fixed_batch(dev, 8)
    t = feat.num_lfr_frames(feat.num_frames(batch[0].shape[1]))
    t_enc = ((t + 1) // 2 + 1) // 2
    with attention_query_rows() as rows:
        reset_counters()
        state, m = train_step(init_fn(), *batch, 0)
        torch.cuda.synchronize()
        counts = read_counters()
    require(np.isfinite(float(m["loss"])), "conv2d conformer: loss not finite")
    require(counts == train_launches(1, 0), f"conv2d conformer step launches {counts}")
    require(rows == [t_enc] * 6, f"conv2d conformer: K1 saw {rows} rows, want 6 x {t_enc}")
    model.eval()
    with torch.inference_mode(), attention_query_rows() as rows:
        feats, feat_lens = parse_batch(batch[0], batch[1], feat)
        enc, enc_lens = model.encode(feats, feat_lens)
        res = beam_search(model, enc, enc_lens, 10, 32)
    require(enc.shape[1] == t_enc and rows == [t_enc] * 6
            and enc_lens.tolist() == [t_enc] * 8, f"conv2d conformer encode: {rows}")
    ids = res.nbest_ids(1)
    require(len(ids) == 8 and np.isfinite(res.scores).all(),
            "conv2d conformer beam: no finite hypothesis")
    print(f"conv2d conformer: {t} LFR frames -> {t_enc} encoder frames; train step loss "
          f"{float(m['loss']):.4f}, K1 on {rows[0]} query rows; beam decode of 8 "
          f"utterances, best scores {res.scores[:, 0].tolist()}")


def _check_remat(dev) -> None:
    """One conformer step of the flagship recipe (hash dropout 0.1) on 8 x
    8 s with ``remat`` off and on, from the same weights: the same loss and
    gradient norm (the recompute replays the dropout draws), and with remat
    K1 launched twice per layer (forward and recompute)."""
    out = {}
    for remat in (False, True):
        cfg, tcfg, feat = _recipe("bfloat16", remat=remat, **CONFORMER)
        model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0)).to(dev)
        opt = make_optimizer(model.parameters(), tcfg, cfg.d_model)
        init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
        batch = fixed_batch(dev, 8)
        reset_counters()
        _, m = train_step(init_fn(), *batch, 0)
        torch.cuda.synchronize()
        out[remat] = (float(m["loss"]), float(m["grad_norm"]), read_counters())
        del model, opt
    (l0, g0, c0), (l1, g1, c1) = out[False], out[True]
    rel = max(abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0))
    print(f"conformer remat, bf16 hash dropout 0.1: loss {l0:.6f} / {l1:.6f}, grad_norm "
          f"{g0:.6f} / {g1:.6f} (off / on, max rel {rel:.2e}); K1 launches "
          f"{c0['fused_attention_fwd']} / {c1['fused_attention_fwd']}")
    require(rel <= 1e-5, "remat changes the conformer step")
    want = train_launches(1, 0)
    require(c0 == want and c1 == {**want, "fused_attention_fwd": 12},
            f"remat launches {c0} / {c1}")


def _check_pad_leak(exp_dir, corpus, dev) -> None:
    """The same utterances' features padded to two lengths (the longer
    padding filled with large noise) give the same valid encoder rows, in
    bf16 (through the kernels) and in f32."""
    model, cfg, feat_cfg, vocab = load_experiment(exp_dir, corpus["vocab"], "best",
                                                  device=dev)
    blob = torch.load(checkpoint_path(exp_dir, "best"), map_location="cpu",
                      weights_only=True)
    model32 = SpeechTransformer(Config(**{**cfg.to_dict(), "dtype": "float32"}),
                                vocab.vocab_size)
    model32.load_state_dict(blob["state_dict"])
    model32 = model32.to(dev).eval()
    _, wave, lengths = next(batched(read_manifest(corpus["dev"]), 4, 15 * 16000, 16000))
    with torch.inference_mode():
        feats, feat_lens = parse_batch(torch.from_numpy(wave).to(dev),
                                       torch.from_numpy(lengths).to(dev), feat_cfg)
        t = feats.shape[1]
        longer = F.pad(feats, (0, 0, 0, 50))
        noise = torch.randn(longer.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0)) * 30
        valid = torch.arange(t + 50, device=dev)[None] < feat_lens[:, None]
        longer = torch.where(valid[..., None], longer, noise)
        for label, m, bound in (("bf16", model, 2e-2), ("f32", model32, 1e-4)):
            a, _ = m.encode(feats, feat_lens)
            b, _ = m.encode(longer, feat_lens)
            err, same = 0.0, True
            for i, n in enumerate(feat_lens.tolist()):
                err = max(err, (a[i, :n].float() - b[i, :n].float()).abs().max().item())
                same = same and torch.equal(a[i, :n], b[i, :n])
            print(f"conformer pad leak, {label}: valid rows at T = {t} and T = {t + 50} "
                  f"(padding of noise 30): max_abs={err:.3e}, bit-identical {same}")
            require(err <= bound, f"conformer {label}: padding leaks into valid rows")


def run_conformer(corpus, dev) -> dict:
    """Phase 14b: the conformer family trained, served and streamed on the
    card. Returns the launch counts of its main paths (training, serving,
    streaming training and serving) and its launches per train step."""
    trained, exp_dir = _train_conformer(corpus)
    served, _ = _serve_conformer(exp_dir, corpus)
    _conv2d_conformer(dev)
    _check_remat(dev)
    # the gap's sources apart: scripts/conformer_grad_gap_torch.py
    check_step_against_cpu(corpus, dev, label="conformer", worst_grads=6, grad_rel=1e-5,
                           **CONFORMER)
    _check_pad_leak(exp_dir, corpus, dev)
    stream_trained, stream_exp = run_streaming_training(
        corpus, num_epoch=1, exp_name="streaming_conformer", model_name="Conformer",
        **CONFORMER)
    stream_served = run_streaming_serving(stream_exp, corpus["vocab"], dev, n_streams=2,
                                          dtypes=("float32",), modes=("ctc_greedy", "beam"))
    step = measure_training_throughput(dev, n_timed=10, label="conformer", **CONFORMER)
    launches = {k: trained[k] + served[k] + stream_trained[k] + stream_served[k]
                for k in COUNTERS}
    return {"launches": launches, "per_step": step["launches_per_step"]}


# -- phase 15: the RNN family --------------------------------------------------

# per model: eval_decode of its main.train run, and the recognize modes the
# JAX package serves it in (the others fail there, as here)
RNN_SERVING = {
    "BiLSTMCTC": ("ctc_greedy", ("ctc_greedy",),
                  ("attention_greedy", "beam", "rescore", "joint")),
    "LAS": ("beam", ("ctc_greedy", "attention_greedy", "beam", "joint"), ("rescore",)),
}


def _train_rnn(name, corpus) -> tuple:
    """``main.train --model_name <name>`` at the registry's widths (f32, rng
    dropout 0.1, its CTC weight) on phase 9's corpus, 1 epoch, with its
    ``eval_decode``; returns (launch counts, experiment dir)."""
    exp_root = os.path.join(WORK, "rnn_exp")
    default = get_model(name)[1]()
    eval_decode = RNN_SERVING[name][0]
    # PyTorch's default, as a user's process starts: the port's cuDNN
    # layers must turn TF32 off themselves (earlier phases have run them)
    torch.backends.cudnn.allow_tf32 = True
    reset_counters()
    t0 = time.perf_counter()
    trainer = main_train(**training_kwargs(
        corpus, exp_root, model_name=name, exp_name=name, num_epoch=1, dtype="float32",
        ctc_weight=default.ctc_weight, eval_decode=eval_decode, eval_beam_size=10,
        drop_exp=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    require(not torch.backends.cudnn.allow_tf32, f"{name} trained with cuDNN's TF32 on")
    model, cfg = trainer.model, trainer.model.cfg
    require(type(model).__name__ == name and cfg.hidden_size == default.hidden_size
            and cfg.num_encoder_layers == default.num_encoder_layers,
            f"main.train did not build the registry's {name}")
    steps, n_eval = trainer.state.step, len(trainer.dev_loader)
    n_params = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"{name} train: {cfg.num_encoder_layers} x BiLSTM {cfg.hidden_size}, CTC "
          f"{cfg.ctc_weight}, {n_params} trained parameters, f32; {steps} steps in 1 epoch, "
          f"{n_eval} dev batches (eval_decode {eval_decode}), wall {wall:.3f} s; "
          f"launches {counts}")
    require(steps == 2, f"{name} train ran {steps} steps, want 2")
    want = {k: 0 for k in COUNTERS}
    # per step K5 1, K3 1, K4 1; per dev batch K5 for the loss and again for
    # the decode, K3 for the loss
    want.update(fbank=steps + 2 * n_eval, ctc_alpha=steps + n_eval, ctc_beta=steps)
    require(counts == want, f"{name} training launches {counts} != {want}")
    rows = _logged_losses(trainer.exp_dir)
    require(len(rows) == steps and all(np.isfinite(r["train/loss"]) for r in rows),
            f"{name} train: missing or non-finite losses")
    for r in rows:
        print(f"{name} train step {r['step']}: loss {r['train/loss']:.4f} grad_norm "
              f"{r['train/grad_norm']:.4f} lr {r['lr']:.3e}")
    with open(os.path.join(trainer.exp_dir, "scalars.jsonl")) as f:
        dev_rows = [r for r in map(json.loads, f) if "dev/loss" in r]
    require(dev_rows and np.isfinite(dev_rows[-1]["dev/decoded_cer"]),
            f"{name}: no finite dev/decoded_cer")
    print(f"{name} dev: loss {dev_rows[-1]['dev/loss']:.4f}, decoded CER "
          f"({eval_decode}) {dev_rows[-1]['dev/decoded_cer']:.2f}")
    exp_dir = trainer.exp_dir
    del trainer, model
    torch.cuda.empty_cache()
    return counts, exp_dir


def _serve_rnn(name, exp_dir, corpus) -> tuple:
    """The trained model through ``recognize`` on the 16 dev utterances in
    every mode the JAX package serves it in (beam 10, batches of 8,
    max_decode_len 32); each mode it cannot serve must raise. Returns the
    launch counts summed over the modes and the joint run's (launch counts,
    decode steps), None without a joint run."""
    model, *_ = _load_experiment_cached(exp_dir, corpus["vocab"], "best",
                                        torch.device("cuda"))
    _, modes, refused = RNN_SERVING[name]
    total, joint = {k: 0 for k in COUNTERS}, None
    for mode in modes:
        steps = (counted_steps(model, "decode_step") if hasattr(model, "decode_step")
                 else contextlib.nullcontext([0]))
        with steps as n_steps:
            reset_counters()
            res = recognize(exp_dir, corpus["vocab"], manifest=corpus["dev"], mode=mode,
                            beam_size=10, batch_size=8, max_decode_len=32, device="cuda")
            torch.cuda.synchronize()
            counts = read_counters()
        n, tm = res["timing"]["batches"], res["timing"]
        require(len(res["utts"]) == 16, f"{name} {mode}: {len(res['utts'])} of 16")
        for utt, entry in res["utts"].items():
            require(entry["output"] and all(np.isfinite(o["score"]) for o in entry["output"]),
                    f"{name} {mode} {utt}: no finite hypothesis")
        want = {k: 0 for k in COUNTERS}
        want.update(fbank=n, ctc_prefix=n_steps[0] if mode == "joint" else 0)
        require(counts == want, f"{name} {mode}: launches {counts} != {want}")
        if mode == "joint":
            require(n_steps[0] > 0, f"{name} joint ran no decode step")
            joint = (counts, n_steps[0])
        total = {k: total[k] + counts[k] for k in COUNTERS}
        print(f"{name} recognize {mode}: {n} batches, {tm['audio_s']:.3f} s audio; per batch "
              f"of 8 encode {tm['encode_s'] / n * 1e3:.3f} ms, search "
              f"{tm['search_s'] / n * 1e3:.3f} ms; audio-s/s "
              f"{tm['audio_s'] / (tm['encode_s'] + tm['search_s']):.3f}; decode steps "
              f"{n_steps[0]}; launches {counts}")
    for mode in refused:
        try:
            recognize(exp_dir, corpus["vocab"], manifest=corpus["dev"], mode=mode,
                      beam_size=10, batch_size=8, max_decode_len=32, device="cuda")
        except AttributeError as err:
            print(f"{name} recognize {mode}: refused as in the JAX package ({err})")
        else:
            raise SystemExit(f"chip_smoke: {name} served mode {mode}, which JAX cannot")
    return total, joint


def run_rnn_family(corpus, dev) -> dict:
    """Phase 15: BiLSTMCTC and LAS trained by ``main.train`` and served by
    ``recognize`` on the card, an f32 step of each against the CPU, 10
    timed steps of each on phase 13's batch. Returns the main paths'
    launch counts, the launches per train step and per LAS joint decode
    step."""
    launches, per_step, joint = {k: 0 for k in COUNTERS}, {}, None
    for name in RNN_NAMES:
        trained, exp_dir = _train_rnn(name, corpus)
        served, joint_run = _serve_rnn(name, exp_dir, corpus)
        joint = joint_run or joint
        launches = {k: launches[k] + trained[k] + served[k] for k in COUNTERS}
        check_step_against_cpu(corpus, dev, label=name, model_name=name)
        step = measure_training_throughput(dev, n_timed=10, label=name, dtype="float32",
                                           device_steps=3, model_name=name)
        per_step[name] = step["launches_per_step"]
    counts, n_steps = joint
    per_joint_step = {k: counts[k] / n_steps for k in COUNTERS}
    require(per_joint_step["ctc_prefix"] == 1.0,
            f"LAS joint: K8 launches per decode step {per_joint_step['ctc_prefix']}")
    return {"launches": launches, "per_step": per_step, "per_joint_step": per_joint_step}


# -- phase 15b: time-warp and attn_impl="flash" -----------------------------------


def check_time_warp(dev) -> None:
    """The warp on the card vs the CPU on the same draws (the fixed batch's
    CMVN log-mel, 64 x 801 x 80, one warp each): within 1e-3; then one
    flagship step with a time warp in its SpecAugment (launches as a
    flagship step, finite loss)."""
    feat = FeatureConfig(fbank_impl="pallas")
    wave, lens = fixed_batch(dev, THROUGHPUT_BATCH)[:2]
    with torch.inference_mode():
        x = log_mel_spectrogram_kernel(wave.float() / 32768.0, feat)
        n = feat.num_frames(lens.long())
        mask = (torch.arange(x.shape[1], device=dev)[None] < n[:, None])[..., None]
        x = (x - x.mean()) / x.std() * mask
        centers, shifts = timewarp.draw_warps(torch.Generator().manual_seed(0), n,
                                              feat.time_warp_param)
        card = timewarp.warp_at(x, n, centers, shifts)
        torch.cuda.synchronize()
        ms = median_ms(lambda: timewarp.warp_at(x, n, centers, shifts), n=10)
        cpu = timewarp.warp_at(x.cpu(), n.cpu(), centers, shifts)
    err = (card.cpu() - cpu).abs().max().item()
    print(f"time warp, card vs cpu on the same draws, {tuple(x.shape)} f32 (shifts "
          f"{shifts.min().item()}..{shifts.max().item()}): max_abs={err:.3e}; card "
          f"{ms:.3f} ms a batch")
    require(err <= 1e-3, "the time warp on the card disagrees with the CPU")
    train_step, state, batch, _ = flagship_train_setup(
        dev, feat_overrides={"num_time_warps": 1})
    reset_counters()
    _, m = train_step(state, *batch, 0)
    torch.cuda.synchronize()
    counts = read_counters()
    require(np.isfinite(float(m["loss"])), "time-warped flagship step: loss not finite")
    require(counts == train_launches(1, 0), f"time-warped step launches {counts}")
    print(f"time-warped flagship step (bf16, SpecAugment with 1 warp of <= "
          f"{feat.time_warp_param} frames): loss {float(m['loss']):.4f}, grad_norm "
          f"{float(m['grad_norm']):.4f}; launches {counts}")


def check_flash(dev) -> dict:
    """``attn_impl="flash"`` against ``"fused"`` from the same weights and
    draws, bit for bit: one flagship step at dropout 0 (loss and gradient
    norm, K1 6 and K2 6 each); and, at hash dropout 0.1, the encoder (the
    only attention ``flash`` takes) forward and backward on the fixed
    batch's shape against ``"fused"`` without the attention-weight dropout
    (flash keeps the output dropout only): outputs and encoder gradients,
    K1 6 and K2 6 each. Returns the launches of the flash step."""
    out = {}
    for impl in ("flash", "fused"):
        train_step, state, batch, _ = flagship_train_setup(dev, attn_impl=impl,
                                                           dropout_rate=0.0)
        reset_counters()
        _, m = train_step(state, *batch, 0)
        torch.cuda.synchronize()
        out[impl] = (float(m["loss"]), float(m["grad_norm"]), read_counters())
        del train_step, state
    (l0, g0, c0), (l1, g1, c1) = out["flash"], out["fused"]
    print(f"flash vs fused flagship step at dropout 0: loss {l0:.6f} / {l1:.6f}, "
          f"grad_norm {g0:.6f} / {g1:.6f}; launches {c0}")
    require(l0 == l1 and g0 == g1, "the flash step differs from the fused step")
    require(c0 == c1 == train_launches(1, 0), f"flash launches {c0} / fused {c1}")

    cfg, gen = flagship_config("bfloat16"), torch.Generator(device=dev).manual_seed(0)
    # the fixed batch's 267 frames, ragged lengths
    feats = torch.randn((THROUGHPUT_BATCH, 267, cfg.input_dim), device=dev, generator=gen)
    lens = torch.randint(134, 268, (THROUGHPUT_BATCH,), device=dev, generator=gen)
    lens[0] = 267
    cot = torch.randn((THROUGHPUT_BATCH, 267, cfg.d_model), device=dev, generator=gen)
    enc_out = {}
    for impl, extra in (("flash", {}), ("fused", {"attn_weight_dropout": False})):
        model = build_model(_recipe("bfloat16", attn_impl=impl, dropout_rate=0.1,
                                    **extra)[0], dev).train()
        reset_counters()
        enc, _ = model.encoder(feats, lens, torch.Generator().manual_seed(2))
        (enc.float() * cot).sum().backward()
        torch.cuda.synchronize()
        grads = [p.grad for p in model.encoder.parameters() if p.grad is not None]
        enc_out[impl] = (enc.detach(), grads, read_counters())
        del model
    (e0, d0, k0), (e1, d1, k1) = enc_out["flash"], enc_out["fused"]
    want = {k: 0 for k in COUNTERS}
    want.update(fused_attention_fwd=6, fused_attention_bwd=6)
    same = torch.equal(e0, e1) and len(d0) == len(d1) and all(
        torch.equal(a, b) for a, b in zip(d0, d1))
    print(f"flash vs fused without weight dropout, encoder at hash dropout 0.1, "
          f"{tuple(feats.shape)} bf16: output and {len(d0)} gradients bit-identical "
          f"{same}; launches {k0}")
    require(same, "the flash encoder differs from the fused one without weight dropout")
    require(k0 == k1 == want, f"flash encoder launches {k0} / fused {k1}")
    return c0


def run_time_warp_and_flash(dev) -> dict:
    """Phase 15b: returns the flash step's launches."""
    check_time_warp(dev)
    return check_flash(dev)


# -- phase 15c: the feature cache, the trace window, the soak driver ------------


CACHE_CHUNK = 32  # ``preprocess features``' default batch_size


def _cache_features(corpus, dev) -> tuple:
    """(a) ``preprocess features`` on the card over phase 9's train and dev
    manifests: K5 once per chunk and nothing else; each cached ``.npy``
    within 1e-5 abs of ``parse_batch`` of its wave alone on the card. Alone
    means a batch of one zero-padded to its chunk's width: a row's last
    frames read the samples past its end (its zero padding, or the reflected
    wave when it is the longest), as in the JAX package, so the width is
    part of the function. Returns ({split: manifest}, launches)."""
    cfg = FeatureConfig(fbank_impl="pallas")
    manifests, launches = {}, {k: 0 for k in COUNTERS}
    worst, unpadded = 0.0, 0.0
    for split in ("train", "dev"):
        out = os.path.join(WORK, "cache", split)
        shutil.rmtree(out, ignore_errors=True)
        reset_counters()
        manifests[split] = preprocess_features(corpus[split], out, batch_size=CACHE_CHUNK,
                                               device="cuda")
        torch.cuda.synchronize()
        counts = read_counters()
        rows = read_manifest(manifests[split])
        n_chunks = -(-len(rows) // CACHE_CHUNK)
        require(counts == {**{k: 0 for k in COUNTERS}, "fbank": n_chunks},
                f"preprocess {split}: launches {counts}, want K5 {n_chunks}")
        launches = {k: launches[k] + counts[k] for k in COUNTERS}
        for i0 in range(0, len(rows), CACHE_CHUNK):
            chunk = rows[i0:i0 + CACHE_CHUNK]
            waves = [load_wav(r["wave"]) for r in chunk]
            width = max(len(w) for w in waves)
            for r, w in zip(chunk, waves):
                cached = torch.from_numpy(np.load(r["feature"])).to(dev)
                for pad, key in ((width, "padded"), (len(w), "unpadded")):
                    x = torch.zeros((1, pad), dtype=torch.float32)
                    x[0, : len(w)] = torch.from_numpy(w)
                    f, n = parse_batch(x.to(dev), torch.tensor([len(w)], device=dev), cfg)
                    require(int(n[0]) == r["frames"] == cached.shape[0], "cached frames")
                    err = (f[0, : int(n[0])] - cached).abs().max().item()
                    if key == "padded":
                        worst = max(worst, err)
                    else:
                        unpadded = max(unpadded, err)
        print(f"preprocess features {split}: {len(rows)} rows in {n_chunks} chunks of "
              f"{CACHE_CHUNK}, K5 {counts['fbank']}")
    print(f"cached features vs parse_batch of the wave alone at its chunk's width: "
          f"max_abs={worst:.3e}; unpadded (the tail reflected, not zero): {unpadded:.3e}")
    require(worst <= 1e-5, "cached features disagree with parse_batch")
    return manifests, launches


def _cached_trainer(corpus, manifests, exp_name, **extra):
    """A ``Trainer(raw_features=True)`` of the flagship recipe over
    cached-feature loaders (phase 9's corpus), as ``main.train`` builds it."""
    kw = training_kwargs(corpus, os.path.join(WORK, "cache_exp"), exp_name=exp_name,
                         **extra)
    model_cls, model_default = get_model(kw["model_name"])
    cfg = resolve_config(data_config().combine(default_train_config()), model_default(), kw)
    feat = feature_config_from(cfg)
    cfg.build(input_dim=feat.feature_dim)
    vocab = Vocab.load(corpus["vocab"])
    loaders = {
        split: BucketedLoader(manifests[split], vocab, batch_size=cfg.batch_size,
                              max_target_len=cfg.max_target_len, shuffle=split == "train",
                              seed=cfg.seed, feat_cfg=feat, drop_last=split == "train")
        for split in ("train", "dev")
    }
    model = model_cls(cfg, vocab.vocab_size, torch.Generator().manual_seed(0)).cuda()
    opt = make_optimizer(model.parameters(), cfg, model_width(cfg))
    return Trainer(model, opt, cfg, feat, vocab, loaders["train"],
                   dev_loader=loaders["dev"], raw_features=True)


def _train_from_cache(corpus, manifests) -> tuple:
    """(b) The flagship recipe for 1 epoch from the cache with
    ``eval_decode=joint``: finite losses; per train step K5 0, K1 6, K2 6,
    K3 1, K4 1; per dev batch K5 0, K1 6 + 6 (the eval step and the
    decode's encode), K3 1; K8 once per joint decode step; then one more
    of the trainer's train steps counted alone. Returns (the run's
    launches, that step's launches)."""
    shutil.rmtree(os.path.join(WORK, "cache_exp"), ignore_errors=True)
    trainer = _cached_trainer(corpus, manifests, "cached", num_epoch=1,
                              eval_decode="joint", eval_beam_size=10)
    reset_counters()
    t0 = time.perf_counter()
    with counted_steps(trainer.model) as n_steps:
        trainer.train()
    torch.cuda.synchronize()
    counts = read_counters()
    steps, n_eval = trainer.state.step, len(trainer.dev_loader)
    want = {**{k: 0 for k in COUNTERS}, "fused_attention_fwd": 6 * steps + 12 * n_eval,
            "fused_attention_bwd": 6 * steps, "ctc_alpha": steps + n_eval,
            "ctc_beta": steps, "ctc_prefix": n_steps[0]}
    rows = _logged_losses(trainer.exp_dir)
    with open(os.path.join(trainer.exp_dir, "scalars.jsonl")) as f:
        dev_rows = [r for r in map(json.loads, f) if "dev/decoded_cer" in r]
    print(f"train from the cache: {steps} steps, {n_eval} dev batches, {n_steps[0]} joint "
          f"decode steps in {time.perf_counter() - t0:.3f} s; losses "
          f"{[round(r['train/loss'], 4) for r in rows]}; dev decoded_cer "
          f"{[r['dev/decoded_cer'] for r in dev_rows]}; launches {counts}")
    require(steps == 2 and len(rows) == steps, f"cached training ran {steps} steps")
    require(all(np.isfinite(r["train/loss"]) for r in rows), "non-finite cached loss")
    require(len(dev_rows) == 1 and n_steps[0] > 0, "no joint decode in the dev eval")
    require(counts == want, f"cached training launches {counts} != {want}")
    # one more train step of the trainer's own, counted alone
    batch = list(trainer.train_loader.epoch(0))[0]
    reset_counters()
    trainer.train_step(trainer.state, *trainer._put_batch(batch), trainer.seed)
    torch.cuda.synchronize()
    per_step = read_counters()
    want_step = {**train_launches(1, 0), "fbank": 0}
    print(f"one cached train step: launches {per_step}")
    require(per_step == want_step, f"a cached train step launches {per_step} != {want_step}")
    return counts, per_step


def _cache_equals_waves(corpus, dev) -> None:
    """(c) One f32 step from the cache equals one from the waves: the same
    weights (seed 0), no SpecAugment, dropout 0; 16 utterances cached as one
    chunk and the same waves padded as that chunk pads them. Loss and
    gradient norm within 1e-5 relative."""
    recs = read_manifest(corpus["train"])[:16]
    manifest = os.path.join(WORK, "cache", "one_chunk.jsonl")
    with open(manifest, "w") as f:
        f.writelines(json.dumps(r, ensure_ascii=False) + "\n" for r in recs)
    cached = read_manifest(preprocess_features(
        manifest, os.path.join(WORK, "cache", "one_chunk"), batch_size=16, device="cuda"))
    waves = [load_wav(r["wave"]) for r in recs]
    wave = np.zeros((16, max(len(w) for w in waves)), np.float32)
    for i, w in enumerate(waves):
        wave[i, : len(w)] = w
    feats = [np.load(r["feature"]) for r in cached]
    feat = np.zeros((16, max(len(x) for x in feats), feats[0].shape[1]), np.float32)
    for i, x in enumerate(feats):
        feat[i, : len(x)] = x
    vocab = Vocab.load(corpus["vocab"])
    ids = [vocab.str_to_ids(r["tgt"]) for r in recs]
    labels = np.zeros((16, max(map(len, ids))), np.int32)
    for i, x in enumerate(ids):
        labels[i, : len(x)] = x
    label_lens = torch.tensor([len(x) for x in ids], dtype=torch.int32)
    cfg, tcfg, fcfg = _recipe("float32", dropout_rate=0.0)
    tcfg.build(spec_augment=False)
    out = {}
    for raw, x, n in ((False, wave, [len(w) for w in waves]),
                      (True, feat, [len(f) for f in feats])):
        model = build_model(cfg, dev)
        opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
        init_fn, train_step, _ = make_step_fns(model, opt, fcfg, tcfg, raw_features=raw)
        _, m = train_step(init_fn(), torch.from_numpy(x).to(dev),
                          torch.tensor(n, dtype=torch.int32, device=dev),
                          torch.from_numpy(labels).to(dev), label_lens.to(dev), 0)
        out[raw] = (float(m["loss"]), float(m["grad_norm"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(out[True], out[False])]
    print(f"f32 step from the cache vs from the waves (16 x {wave.shape[1]} samples): loss "
          f"{out[True][0]:.6f} vs {out[False][0]:.6f} (rel {rel[0]:.2e}), grad_norm "
          f"{out[True][1]:.6f} vs {out[False][1]:.6f} (rel {rel[1]:.2e})")
    require(max(rel) <= 1e-5, "a step from the cache disagrees with one from the waves")


TRACE_KERNELS = {  # the kernels' names in a trace, and launches per train step
    "K1 attention_fwd_mma_kernel": 6, "K2 attention_bwd_dq_mma_kernel": 6,
    "K2 attention_bwd_dkdv_mma_kernel": 6, "K3 ctc_emission_rows_kernel": 1,
    "K3 ctc_alpha_recursion_kernel": 1, "K4 ctc_beta_recursion_kernel": 1,
    "K4 ctc_grad_rows_kernel": 1, "K5 fbank_mma_kernel": 1,
}


def _check_trace_window(corpus) -> dict:
    """(d) ``main.train`` with ``profile_from_step=2 profile_steps=2``: one
    trace under ``exp_dir/trace/`` with two ``train_step`` ranges, host and
    card, and inside the card's ranges each kernel of a train step exactly
    as often as two steps launch it, none outside. Returns the run's
    launches."""
    exp_root = os.path.join(WORK, "trace_exp")
    shutil.rmtree(exp_root, ignore_errors=True)
    reset_counters()
    trainer = main_train(**training_kwargs(corpus, exp_root, dev_manifest=None,
                                           exp_name="trace", profile_from_step=2,
                                           profile_steps=2))
    torch.cuda.synchronize()
    counts = read_counters()
    require(counts == train_launches(trainer.state.step, 0),
            f"trace run launches {counts}")
    trace_dir = os.path.join(trainer.exp_dir, "trace")
    files = os.listdir(trace_dir)
    require(len(files) == 1, f"want one trace, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e["name"] == "train_step"
            and e.get("cat") == "user_annotation"]
    gpu = [e for e in events if e["name"] == "train_step"
           and e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # the trace is the window: the profiler records from just before the
    # first of its steps to just after the last
    found = {label: sum(label.split()[1] in k["name"] for k in kernels)
             for label in TRACE_KERNELS}
    inside = {label: sum(label.split()[1] in k["name"] for k in kernels
                         if any(g["ts"] <= k["ts"] <= g["ts"] + g["dur"] for g in gpu))
              for label in TRACE_KERNELS}
    print(f"trace window: {files[0]}, {len(host)} host and {len(gpu)} card train_step "
          f"ranges, {len(kernels)} kernels; the kernels of a train step: {found}; of "
          f"them inside the card's ranges: {inside}")
    require(len(host) == len(gpu) == 2,
            f"want two train_step ranges, found {len(host)} host and {len(gpu)} card")
    # each kernel two steps' worth, all inside the card's train_step ranges
    want = {label: 2 * per_step for label, per_step in TRACE_KERNELS.items()}
    require(found == inside == want, f"trace: kernels {found}, inside {inside}, want {want}")
    return counts


def _soak_driver(corpus) -> None:
    """(e) ``scripts/soak_flagship_torch.py``'s phase functions at flagship
    width on phase 9's corpus (2 batches an epoch) for 3 epochs with
    ``save_every_iter=1``: SIGKILL at the first checkpoint at step >= 2,
    a resume that starts at the saved step, ``joint`` and ``beam`` decodes
    of the dev set (CER printed, not gated)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "soak_flagship_torch", os.path.join(ROOT, "scripts", "soak_flagship_torch.py"))
    soak = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(soak)
    root = os.path.join(WORK, "soak")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    exp_root = os.path.join(root, "exp")
    exp_dir = os.path.join(exp_root, soak.EXP_NAME)
    paths = {**corpus, "test": ""}
    extra = {"num_epoch": 3, "save_every_iter": 1, "log_every_iter": 1,
             "eval_every_iter": 0, "use_native_io": "false"}
    kill = soak.run_until_killed(soak.train_cmd(paths, exp_root, extra), exp_dir,
                                 kill_step=2, log_path=os.path.join(root, "phase1.log"))
    soak.run_to_completion(soak.train_cmd(paths, exp_root, {**extra, "from_ckpt": "latest"}),
                           os.path.join(root, "phase2.log"))
    summary = soak.summarize(exp_dir, kill)
    resume = summary["resume"]
    require(resume["first_logged_step_after_resume"] == kill["step"] + 1,
            f"the resume did not start at the saved step: {resume}")
    cer = {mode: soak.decode(paths, exp_dir, mode, os.path.join(root, f"decode_{mode}.json"))
           for mode in ("joint", "beam")}
    print(f"soak driver: killed at {kill['checkpoint']}, resumed at step "
          f"{resume['first_logged_step_after_resume']} lr {resume['first_lr_after_resume']:.3e}"
          f", ended at {summary['checkpoints']['latest']}; dev CER {cer}")


def run_cache_trace_soak(corpus, dev) -> dict:
    """Phase 15c: the feature cache (preprocess on the card, training from
    it, cache = waves), the trainer's trace window and the soak driver at
    tiny scale. Returns the launches of its main paths and per cached train
    step."""
    manifests, preprocessed = _cache_features(corpus, dev)
    cached, per_step = _train_from_cache(corpus, manifests)
    _cache_equals_waves(corpus, dev)
    traced = _check_trace_window(corpus)
    _soak_driver(corpus)
    launches = {k: preprocessed[k] + cached[k] + traced[k] for k in COUNTERS}
    return {"launches": launches, "per_step": per_step}


# -- phase 16: parallel on the card ----------------------------------------------

PARALLEL_BATCH, PARALLEL_STEPS = 16, 3
# a constant lr: 3 Adam steps move each weight by about 3 lr, far above the
# bounds (Noam's first steps at the flagship's width would move it by 5e-7)
PARALLEL_LR = 1e-3
# per dtype: losses and gradient norms (relative)
PARALLEL_BOUNDS = {"float32": 1e-5, "bfloat16": 2e-2}
# per dtype, per parameter: the first step's gradient and the move over the
# steps, |diff| / |ref|. Set from scripts/parallel_grad_gap_torch.py on the
# H100: in f32 9.4e-5 and 3.1e-2, from the feed-forward ReLUs (1222 of
# their signs differ over the steps; with one process's signs imposed on
# the ranks 5.4e-6 and 3.5e-4), Adam turning a sign-flipped near-zero
# gradient into a +-lr move; in bf16 5.3e-2 and 0.18. A skipped, reversed
# or doubled update moves a parameter by 1, 2 or 1 of its move.
PARALLEL_GRAD_REL = {"float32": 2e-4, "bfloat16": 1e-1}
PARALLEL_MOVE_REL = {"float32": 5e-2, "bfloat16": 3e-1}
PARALLEL_SCORE_REL = 1e-5  # beam scores, of max(1, |score|): sums of ~64 log-probs


def _parallel_recipe(dtype: str, **overrides):
    """(model config, train config, feature config) of phase 16: the
    flagship recipe at hash dropout 0.1 without the attention weights' (a
    data-parallel attention call folds its rank into the keep hash's seed,
    as the JAX package's sharded call does, so its weight dropout is not one
    process's; ``tests/test_torch_parallel.py`` holds that fold to JAX's),
    no SpecAugment, a constant lr of ``PARALLEL_LR``."""
    cfg, tcfg, feat = _recipe(dtype, attn_weight_dropout=False, **overrides)
    tcfg = default_train_config().combine(cfg).build(
        spec_augment=False, lr_schedule="constant", lr=PARALLEL_LR)
    return cfg, tcfg, feat


def _parallel_steps(dtype: str, dev, mesh, **overrides) -> dict:
    """``PARALLEL_STEPS`` flagship steps (``overrides``: model config) on
    this rank's rows of the global batch of ``PARALLEL_BATCH`` x 8 s (all
    of it without a data axis), from seed-0 weights: losses, gradient
    norms, the first step's gradients, each parameter's move over the
    steps, the launches of the steps and the wall ms of the last two."""
    cfg, tcfg, feat = _parallel_recipe(dtype, **overrides)
    model = build_model(cfg, dev)
    start = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
    opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
    batch = [x[batch_rows(mesh, PARALLEL_BATCH)] for x in fixed_batch(dev, PARALLEL_BATCH)]
    losses, norms, times, grads = [], [], [], None
    with active_mesh(mesh):
        state = init_fn()
        reset_counters()
        for _ in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train_step(state, *batch, 0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append((time.perf_counter() - t0) * 1e3)
            if grads is None:  # the first step's, summed over the ranks and clipped
                grads = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}
    counts = read_counters()
    return {"losses": losses, "norms": norms, "ms": statistics.median(times[1:]),
            "launches": {k: v / PARALLEL_STEPS for k, v in counts.items()}, "grads": grads,
            "moves": {k: p.detach().float().cpu() - start[k]
                      for k, p in model.named_parameters()}}


def parallel_gaps(got: dict, ref: dict) -> dict:
    """Two runs of ``_parallel_steps`` apart: the largest relative gap of
    their losses and gradient norms, and per parameter |diff| / |ref| of
    the first step's gradient and of the move over the steps, the key
    projections' biases left out (their gradient is zero in exact
    arithmetic, a softmax not seeing a shift of its row, so all rounding,
    and Adam moves such a weight by +-lr on the rounding's sign)."""
    def own(a, b):
        return {k: float((a[k] - v).norm() / v.norm().clamp_min(1e-30))
                for k, v in b.items() if not k.endswith("k_proj.bias")}

    rel = max(max(abs(a - b) / abs(b) for a, b in zip(got[k], ref[k]))
              for k in ("losses", "norms"))
    return {"rel": rel, "grads": own(got["grads"], ref["grads"]),
            "moves": own(got["moves"], ref["moves"])}


def worst(gaps: dict) -> tuple:
    """(name, gap) of the largest of ``gaps``."""
    name = max(gaps, key=gaps.get)
    return name, gaps[name]


def _serving_beam(manifest, dev, mesh=None):
    """phase 8's serving batch (the first 8 utterances) through an f32
    seed-0 flagship: ``beam_search`` (beam 10), or with ``mesh``
    ``distributed_beam_search`` over its data axis."""
    model = SpeechTransformer(flagship_config("float32"), VOCAB,
                              torch.Generator().manual_seed(0)).to(dev).eval()
    enc, lens = _first_batch(model, FeatureConfig(fbank_impl="pallas"), manifest, dev)
    with torch.inference_mode():
        if mesh is None:
            return beam_search(model, enc, lens, 10, 64).materialize()
        return distributed_beam_search(model, enc, lens, 10, 64, mesh).materialize()


def _parallel_rank(manifest: str) -> dict:
    """One of the two ranks on the card: data-parallel steps in f32 and
    bf16, and the distributed beam."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=2)
    out = {dtype: _parallel_steps(dtype, dev, mesh) for dtype in PARALLEL_BOUNDS}
    res = _serving_beam(manifest, dev, mesh)
    out["beam"] = (res.tokens, res.scores, res.finished)
    return out


def _axis_size_one(dev) -> None:
    """Ring attention and tensor parallelism on a (1, 1, 1) mesh: the f32
    flagship encoder with ``attn_impl="ring"`` equals the xla one's, and a
    train step under the mesh (``shard_model_`` a no-op) equals one without,
    bit for bit."""
    mesh = make_mesh()
    cfg, _, feat = _parallel_recipe("float32")
    batch = fixed_batch(dev, 2)
    encs = []
    for impl in ("ring", "xla"):
        model = build_model(Config(**{**cfg.to_dict(), "attn_impl": impl}), dev).eval()
        with active_mesh(mesh), torch.inference_mode():
            feats, lens = parse_batch(batch[0], batch[1], feat)
            encs.append(model.encode(feats, lens)[0])
    steps = []
    for m in (mesh, None):
        cfg, tcfg, feat = _parallel_recipe("float32")
        model = build_model(cfg, dev)
        shard_model_(model, mesh)
        opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
        init_fn, train_step, _ = make_step_fns(model, opt, feat, tcfg)
        with active_mesh(m):
            _, metrics = train_step(init_fn(), *batch, 0)
        steps.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    print(f"axis size 1: ring encoder = xla encoder {torch.equal(encs[0], encs[1])}; a step "
          f"under the (1, 1, 1) mesh = one without {steps[0] == steps[1]} {steps[0]}")
    require(torch.equal(encs[0], encs[1]) and steps[0] == steps[1],
            "ring / tensor parallelism at axis size 1 differ from the unsharded model")


def run_parallel(serve_corpus, dev) -> dict:
    """Phase 16: two ranks on the one card (gloo, CUDA tensors): data-
    parallel flagship steps in f32 and bf16 against one process on the same
    global batch, their launches per rank and step, the distributed beam
    against one process's beam, and ring / tensor parallelism at axis size
    1. Returns the ms per step of each."""
    one = {dtype: _parallel_steps(dtype, dev, None) for dtype in PARALLEL_BOUNDS}
    want_beam = _serving_beam(serve_corpus["test"], dev)
    ranks = run_ranks(2, _parallel_rank, serve_corpus["test"])
    timing = {"one_process_ms": {}, "rank_ms": {}}
    for dtype, bound in PARALLEL_BOUNDS.items():
        ref = one[dtype]
        timing["one_process_ms"][dtype] = ref["ms"]
        timing["rank_ms"][dtype] = [r[dtype]["ms"] for r in ranks]
        for rank, r in enumerate(ranks):
            got = r[dtype]
            gaps = parallel_gaps(got, ref)
            (g_name, g_gap), (w_name, w_gap) = worst(gaps["grads"]), worst(gaps["moves"])
            g_bound, w_bound = PARALLEL_GRAD_REL[dtype], PARALLEL_MOVE_REL[dtype]
            print(f"parallel {dtype} rank {rank}: {PARALLEL_STEPS} steps of {PARALLEL_BATCH // 2}"
                  f" rows vs one process of {PARALLEL_BATCH} at lr {PARALLEL_LR:.0e}: losses "
                  f"{got['losses']} vs {ref['losses']}, loss/grad norm max rel "
                  f"{gaps['rel']:.3e} (bound {bound:.0e}); per parameter, the first step's "
                  f"gradient max |diff| / |g| {g_gap:.3e} ({g_name}; bound {g_bound:.0e}), the "
                  f"move over the steps max |diff| / |move| {w_gap:.3e} ({w_name}; bound "
                  f"{w_bound:.0e}); {got['ms']:.1f} ms/step on the rank vs {ref['ms']:.1f} in "
                  f"one process; launches per step {got['launches']}")
            require(gaps["rel"] <= bound and g_gap <= g_bound and w_gap <= w_bound,
                    f"parallel {dtype}: rank {rank} disagrees with one process")
            want = flagship_step_launches()
            require(got["launches"] == want,
                    f"parallel {dtype}: rank {rank} launches {got['launches']} != {want}")
    for rank, r in enumerate(ranks):
        tokens, scores, finished = r["beam"]
        diff = np.abs(scores - want_beam.scores)
        rel = float((diff / np.maximum(1.0, np.abs(want_beam.scores))).max())
        same = np.array_equal(tokens, want_beam.tokens)
        print(f"distributed beam, rank {rank}: 8 utterances over data 2 vs one process: "
              f"tokens equal {same}, finished equal "
              f"{np.array_equal(finished, want_beam.finished)}, scores max_abs="
              f"{float(diff.max()):.3e}, of max(1, |score|) {rel:.3e} (bound "
              f"{PARALLEL_SCORE_REL:.0e})")
        require(same and np.array_equal(finished, want_beam.finished)
                and rel <= PARALLEL_SCORE_REL,
                f"distributed beam: rank {rank} disagrees with one process")
    _axis_size_one(dev)
    return timing


# -- phase 17: the benches ----------------------------------------------------

BENCH_DECODE_MODES = ("lazy", "gather", "joint")
# beam scores, of max(1, |score|), lazy against gather in f32 (as phase 16's
# distributed beam against one process)
BENCH_SCORE_REL = 1e-5


@contextlib.contextmanager
def counted_class_steps(cls, method):
    """Count the decode steps of every instance of ``cls`` while the block
    runs (``counted_steps`` for a model built out of reach)."""
    n = [0]
    inner = getattr(cls, method)

    def step(self, *a, **kw):
        n[0] += 1
        return inner(self, *a, **kw)

    setattr(cls, method, step)
    try:
        yield n
    finally:
        setattr(cls, method, inner)


def run_benches() -> dict:
    """Phase 17: each measuring program at flagship width, short:
    ``bench.via_trainer_main`` on 4 batches of 64 x 8 s (per step the
    flagship's launches), ``scripts/bench_decode_torch.py::main`` once per
    mode with 1 timed search (per batch K5 1 and K1 6 for the encode, K8
    once a decode step in ``joint`` and never in the others; ``lazy`` and
    ``gather`` in f32 give the same best hypotheses and scores within 1e-5,
    in bf16 their agreement is printed), ``scripts/bench_stream_torch.py`` at
    bucket 8 s with 2 timed calls, one component pass of
    ``scripts/profile_torch_decode.py`` and ``bench.scaling_main`` at count
    1 (one NCCL rank); every number finite and positive. Returns the
    launches per bench-decode batch by mode and the launches counted."""
    counted = {k: 0 for k in COUNTERS}

    def take(counts):
        for k, v in counts.items():
            counted[k] += v
        return counts

    reset_counters()
    r = bench.via_trainer_main(n_batches=4, corpus_dir=os.path.join(WORK, "bench_corpus"))
    per_step = {k: v / 8 for k, v in take(read_counters()).items()}
    require(per_step == flagship_step_launches(), f"via_trainer_main launches {per_step}")
    require_positive("via_trainer_main", r, ("value", "steps_per_s", "mfu"))

    per_batch, tokens = {}, {}
    for mode in BENCH_DECODE_MODES:
        reset_counters()
        method = "decode_step" if mode == "gather" else "decode_step_lazy"
        with counted_class_steps(SpeechTransformer, method) as steps:
            r = bench_decode_torch.main(n_iters=1, modes=mode)[mode]
        counts = take(read_counters())
        want = {k: 0 for k in COUNTERS}
        want.update(fbank=1, fused_attention_fwd=6, ctc_prefix=steps[0] if mode == "joint" else 0)
        require(counts == want, f"bench decode {mode}: launches {counts} != {want} "
                f"({steps[0]} decode steps in 2 searches)")
        require_positive(f"bench decode {mode}", r, ("ms_per_batch", "audio_s_per_s"))
        # per batch: the one encode, and one of the two searches
        per_batch[mode] = {k: v / 2 if k == "ctc_prefix" else v for k, v in counts.items()}
        tokens[mode] = r
        print(f"bench decode {mode}: {steps[0] // 2} decode steps a search, launches per "
              f"batch of 64 {per_batch[mode]}")
    # the two reorders round the self-attention in other orders (lazy sums
    # over every slot's cache, the absent ones weighted zero, in one product
    # over slots and positions), so hypotheses at a near tie may swap or
    # part. bf16: printed. f32: every best hypothesis equal and the n-best
    # scores within BENCH_SCORE_REL, required.
    reset_counters()
    tokens["f32"] = bench_decode_torch.main(n_iters=1, modes="lazy,gather", dtype="float32")
    take(read_counters())
    agree = {}
    for dtype, (lazy, gather) in (("bf16", (tokens["lazy"], tokens["gather"])),
                                  ("f32", (tokens["f32"]["lazy"], tokens["f32"]["gather"]))):
        a, b = lazy["tokens"], gather["tokens"]
        rel = float((np.abs(lazy["scores"] - gather["scores"])
                     / np.maximum(1.0, np.abs(gather["scores"]))).max())
        same_set = np.mean([sorted(map(tuple, x)) == sorted(map(tuple, y)) for x, y in zip(a, b)])
        agree[dtype] = (bool((a[:, 0] == b[:, 0]).all()), rel)
        print(f"bench decode {dtype}, lazy vs gather over 64 utterances: best hypothesis equal "
              f"in {(a[:, 0] == b[:, 0]).all(-1).mean() * 100:.1f} %, the whole n-best in "
              f"{(a == b).all((1, 2)).mean() * 100:.1f} %, the same n-best as a set in "
              f"{same_set * 100:.1f} %; scores max |diff| / max(1, |score|) {rel:.3e}")
    require(agree["f32"][0] and agree["f32"][1] <= BENCH_SCORE_REL,
            f"bench decode f32: lazy and gather disagree {agree['f32']}")

    s = bench_stream_torch.main(bucket_seconds="8", n_iters=2)
    require(len(s["rows"]) == 3 and len(s["incremental"]) == 3, "stream bench rows")
    for mode, _, partial, final in s["rows"]:
        require_positive(f"stream bench {mode}", {"partial": partial, "final": final},
                         ("partial", "final"))
    for row in s["incremental"]:
        require_positive(f"stream bench incremental {row['mode']}", row,
                         ("partial_mean_ms", "partial_p95_ms", "final_ms"))

    p = profile_torch_decode.main(n=3, do_trace=False)
    require_positive("decode profile", p["components"], list(p["components"]))

    r = bench.scaling_main(chip_counts="1", n_steps=5)
    require(r["table"][0]["efficiency"] == 1.0, f"scaling table {r['table']}")
    require_positive("scaling_main", r["table"][0], ("audio_s_per_s_per_chip", "mfu"))
    return {"per_batch": per_batch, "launches": counted}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.3f} s: {lib_path}")

    def phase(number, fn, *args):
        """Run one phase and print what it took of the run's time."""
        start = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"phase {number} ({fn.__name__}): {now - start:.1f} s, {now - t0:.1f} s so far")
        return out

    fbank = phase(3, check_fbank, dev)
    attn = phase(4, check_attention, dev)
    attn_bwd = phase(5, check_attention_bwd, dev)
    banded_fwd, banded_bwd = phase(6, check_banded, dev)
    ctc_alpha, ctc_beta = phase(7, check_ctc, dev)
    serve, serve_batches, serve_corpus, serve_exp = phase(8, run_serving_path, dev)
    decoded, joint_batches, joint = phase("8b", run_decoding_modes, serve_exp, serve_corpus,
                                          dev)
    trained, corpus, train_exp = phase(9, run_training_path, dev)
    phase("9b", check_eval_decode, train_exp, corpus, dev)
    phase(10, check_step_against_cpu, corpus, dev)
    stream_trained, stream_exp = phase(11, run_streaming_training, corpus)
    stream_served = phase(12, run_streaming_serving, stream_exp, corpus["vocab"], dev)
    flagship_step = phase(13, measure_flagship_throughput, dev)["launches_per_step"]
    streaming_step = phase(14, measure_streaming_throughput, dev)
    conformer = phase("14b", run_conformer, corpus, dev)
    rnn = phase(15, run_rnn_family, corpus, dev)
    flash_step = phase("15b", run_time_warp_and_flash, dev)
    cache = phase("15c", run_cache_trace_soak, corpus, dev)
    phase(16, run_parallel, serve_corpus, dev)
    benches = phase(17, run_benches)

    # launches: the main paths' runs, each counted from 0
    launches = {
        k: serve[k] + decoded[k] + trained[k] + stream_trained[k] + stream_served[k]
        + conformer["launches"][k] + rnn["launches"][k] + cache["launches"][k]
        + benches["launches"][k] + joint["rescore"][0][k]
        for k in COUNTERS
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
        "ctc_prefix": ("ctc_prefix.cu",
                       "none (lax.scan): asr_chinese_e2e_tpu/decode/joint.py:253",
                       joint["k8"]),
        "ctc_prefix_beam": ("ctc_prefix_beam.cu",
                            "none (lax.scan): asr_chinese_e2e_tpu/decode/ctc_prefix_device.py:214",
                            joint["k9"]),
    }
    rescore_counts, rescore_batches = joint["rescore"]
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"asr_chinese_e2e_tpu_torch/ops/csrc/{src}", "replaces": rep,
         "launches": launches[name],
         "launches_per_step": {
             "flagship_train_step": flagship_step[name],
             "streaming_train_step": streaming_step[name],
             "conformer_train_step": conformer["per_step"][name],
             "bilstm_ctc_train_step": rnn["per_step"]["BiLSTMCTC"][name],
             "las_train_step": rnn["per_step"]["LAS"][name],
             "flash_train_step": flash_step[name],
             "cached_train_step": cache["per_step"][name],
             "serving_batch": serve[name] / serve_batches,
             "joint_serving_batch": decoded[name] / joint_batches,
             "rescore_serving_batch": rescore_counts[name] / rescore_batches,
             "las_joint_decode_step": rnn["per_joint_step"][name],
             **{f"bench_decode_{mode}_batch": benches["per_batch"][mode][name]
                for mode in BENCH_DECODE_MODES},
         }, **measured}
        for name, (src, rep, measured) in sources.items()
    ]
    kernels[-2]["launches_per_step"]["joint_decode_step"] = (
        decoded["ctc_prefix"] / joint["steps_run"])
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
