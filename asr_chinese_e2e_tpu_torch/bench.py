r"""Training-throughput benchmark of the port (the root ``bench.py`` of the
JAX package), on one H100 unless the caller asks for the CPU:

    python -m asr_chinese_e2e_tpu_torch.bench [--n_steps 40 --batch 64 ...]
    python -m asr_chinese_e2e_tpu_torch.bench --via_trainer true [--n_batches 120]
    python -m asr_chinese_e2e_tpu_torch.bench --scaling true [--chip_counts 1,2]
    python -m asr_chinese_e2e_tpu_torch.bench --device cpu --d_model 16 ...  # tiny, plain

Each mode prints ONE JSON line, last, with the JAX bench's keys and
``card`` (``nvidia-smi``'s name and power limit, or ``"cpu"``):

- ``main``: the flagship recipe (512d/8h/6+6L, bf16, CTC 0.3 through K3/K4,
  fused attention K1/K2 with hash dropout 0.1, the fbank kernel K5,
  SpecAugment, Noam + Adam, clip 5) on one fixed batch of ``batch`` x
  ``seconds`` drawn as the JAX bench draws it; one first step, 2 warm-up
  steps, then ``n_steps`` timed. ``train_throughput_audio_seconds_per_sec_
  per_chip``, ``steps_per_s``, ``flops_per_step`` (``analytic_train_flops``)
  and ``mfu`` against the H100 SXM's dense peak of the step's dtype (null
  off the card: a CPU run measures no device).
- ``via_trainer_main``: the real ``Trainer.train_epoch`` (loader, int16
  wire, device transfer, metric reads) on a synthetic corpus of fixed
  length; epoch 0 warms up, epoch 1 is timed wall to wall.
- ``scaling_main``: weak scaling, ``per_chip_batch`` rows a rank, one
  process per card over NCCL (gloo ranks on the CPU, through
  ``parallel/dryrun.py::run_ranks``); a table per count and
  ``dp_weak_scaling_efficiency`` against the first count. Counts above the
  cards present are refused: two ranks on one card measure sharing, not
  scaling.

Left out (ROADMAP item 9): ``steps_per_dispatch`` > 1 (``make_multi_step``)
raises.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from .data.batching import BucketedLoader
from .data.features import FeatureConfig
from .data.vocab import Vocab
from .models.transformer import SpeechTransformer, default_config
from .parallel.context import active_mesh
from .parallel.dryrun import run_ranks
from .parallel.sharding import make_mesh, shard_batch
from .train.optimizer import default_train_config, make_optimizer, model_width
from .train.train_step import make_step_fns
from .train.trainer import Trainer
from .utils.cli import parse_kwargs
from .utils.synth import make_synth_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# NVIDIA H100 SXM datasheet: dense bf16 tensor-core peak, FLOP/s
H100_SXM_BF16_PEAK = 989.4e12
# same datasheet: f32 outside the tensor cores, FLOP/s; device memory, bytes/s
H100_SXM_F32_PEAK = 67e12
H100_SXM_BYTES_PER_S = 3.35e12
RNN_NAMES = ("BiLSTMCTC", "LAS")
BATCH_KEYS = ("wave", "wave_lengths", "labels", "label_lengths")
# the JAX bench steps with jax.random.key(1)
STEP_SEED = 1
# gloo ranks a CPU scaling sweep takes by default (JAX's virtual mesh has 8)
CPU_RANKS = 8


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: str) -> torch.device:
    """``device`` ("cuda" unless the caller asks for "cpu"); this process's
    card under a process group. Asking for the card without one raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device=cuda but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sync(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_of(dev: torch.device) -> str:
    """``card_line()`` on the card, ``"cpu"`` off it."""
    return card_line() if dev.type == "cuda" else "cpu"


def peak_flops(dtype: str) -> float:
    """The H100 SXM's dense peak for a step in ``dtype``."""
    return H100_SXM_BF16_PEAK if dtype == "bfloat16" else H100_SXM_F32_PEAK


def _no_multi_step(steps_per_dispatch) -> None:
    if int(steps_per_dispatch) > 1:
        raise ValueError(
            "steps_per_dispatch > 1 (make_multi_step) is not ported (ROADMAP item 9: "
            "a TPU remote-dispatch workaround); the port dispatches one step a call")


def analytic_train_flops(cfg, feat_cfg, vocab_size: int, batch: int,
                         n_samples: int, label_len: int) -> float:
    """Matmul FLOPs of one train step (fwd + bwd = 3x fwd), the JAX bench's
    count (projections, attention products, FFNs, vocabulary heads, the
    DFT-as-matmul fbank; elementwise work excluded, as MFU accounting
    does), with the conformer block (its second FFN, the conv module's
    pointwise d -> 2d and d -> d and its depthwise conv, k taps a channel a
    frame), the conv2d frontend (two 3x3 convolutions and the projection,
    over 4x fewer encoder frames) and the RNN family (``rnn_forward_flops``)
    counted too."""
    t_frames = feat_cfg.num_frames(n_samples)
    t = feat_cfg.num_lfr_frames(t_frames)
    l = label_len + 1  # decoder is BOS-prefixed
    v = vocab_size
    n_bins = feat_cfg.n_fft // 2 + 1
    fwd = t_frames * feat_cfg.win_length * (2 * n_bins) * 2
    fwd += t_frames * n_bins * feat_cfg.n_mels * 2
    if cfg.get("model_name") in RNN_NAMES:
        return 3.0 * (fwd + rnn_forward_flops(cfg, feat_cfg, v, t, l)) * batch
    d, ff = cfg.d_model, cfg.d_ff
    le, ld = cfg.num_encoder_layers, cfg.num_decoder_layers
    if cfg.get("frontend", "linear") == "conv2d":
        c, f = d // 8, feat_cfg.feature_dim
        t1, f1 = -(-t // 2), -(-f // 2)
        t, f2 = -(-t1 // 2), -(-f1 // 2)
        fwd += t1 * f1 * c * 9 * 2 + t * f2 * c * 9 * c * 2 + t * f2 * c * d * 2
    else:
        fwd += t * feat_cfg.feature_dim * d * 2
    layer = 4 * t * d * d * 2 + 2 * t * t * d * 2 + 2 * t * d * ff * 2
    if cfg.get("encoder_type", "transformer") == "conformer":
        k = cfg.get("conv_kernel_size", 15)
        layer += 2 * t * d * ff * 2 + t * d * 2 * d * 2 + t * d * d * 2 + t * d * k * 2
    fwd += le * layer
    if float(cfg.get("ctc_weight", 0.0)) > 0:
        fwd += t * d * v * 2
    fwd += ld * (4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2
                 + 2 * t * d * d * 2 + 2 * l * t * d * 2 + 2 * l * d * ff * 2)
    fwd += l * d * v * 2
    return 3.0 * fwd * batch


def rnn_forward_flops(cfg, feat_cfg, v: int, t: int, l: int) -> int:
    """Matmul FLOPs of one utterance's RNN forward past the fbank: each
    LSTM direction's gates (4h x (in + h) a frame), the CTC head, and for
    LAS per target position the decoder cell, the query projection, the
    location conv (filters x kernel a frame), its projection, the score and
    the context products and the output projection over [s, context],
    with the encoder's projection once."""
    h, n_in = cfg.hidden_size, feat_cfg.feature_dim
    fwd = 0
    for i in range(cfg.num_encoder_layers):
        fwd += 2 * t * 4 * h * ((n_in if i == 0 else 2 * h) + h) * 2
    if float(cfg.get("ctc_weight", 0.0)) > 0:
        fwd += t * 2 * h * v * 2
    if cfg.get("model_name") == "LAS":
        e, a, f, k = cfg.embed_dim, cfg.attention_dim, cfg.location_filters, cfg.location_kernel
        step = 4 * h * (e + 2 * h + h) * 2 + h * a * 2
        step += t * f * k * 2 + t * f * a * 2 + t * a * 2 + t * 2 * h * 2
        step += (h + 2 * h) * v * 2
        fwd += l * step + t * 2 * h * a * 2
    return fwd


def host_batch(batch: int, samples: int, vocab_size: int, label_len: int) -> dict:
    """The JAX bench's fixed batch, the same numpy draws in the same order:
    float32 waves ``randn * 0.1``, then labels in [4, V)."""
    rng = np.random.RandomState(0)
    return {
        "wave": np.asarray(rng.randn(batch, samples) * 0.1, np.float32),
        "wave_lengths": np.full((batch,), samples, np.int32),
        "labels": rng.randint(4, vocab_size, size=(batch, label_len)).astype(np.int32),
        "label_lengths": np.full((batch,), label_len, np.int32),
    }


def main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,  # AISHELL-1 char vocabulary scale
    label_len: int = 20,
    ctc_weight: float = 0.3,
    dtype: str = "bfloat16",
    n_steps: int = 40,
    sync_every: int = 0,  # steps per torch.cuda.synchronize; 0 = once at the end
    attn_impl: str = "fused",
    fbank_impl: str = "pallas",
    dropout_impl: str = "hash",
    steps_per_dispatch: int = 1,
    n_chips: int = 0,  # 0 = this process group's ranks, one card each
    device: str = "cuda",
    _return_result: bool = False,
    **model_overrides,
):
    """Throughput of the flagship train step on one fixed batch; under a
    process group of n ranks (``scaling_main``) ``batch`` is the global
    batch and each rank steps on its rows over a data mesh."""
    _no_multi_step(steps_per_dispatch)
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if int(n_chips) not in (0, world):
        raise ValueError(f"n_chips={n_chips}: the port runs one process per card and this "
                         f"process group has {world} (scaling_main starts the ranks)")
    n_chips = world
    log(f"device {dev}, {n_chips} rank(s)")

    feat_cfg = FeatureConfig(fbank_impl=fbank_impl)
    cfg = default_config().build(
        ctc_weight=ctc_weight, dtype=dtype, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl, dropout_impl=dropout_impl, **model_overrides,
    )
    tcfg = default_train_config().combine(cfg).build(spec_augment=True)
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0)).to(dev)
    optimizer = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, optimizer, feat_cfg, tcfg)

    samples = int(seconds * feat_cfg.sample_rate)
    hb = host_batch(batch, samples, vocab_size, label_len)
    mesh = make_mesh(data=n_chips) if n_chips > 1 else None
    args = [torch.from_numpy(x).to(dev)
            for x in shard_batch(mesh, [hb[k] for k in BATCH_KEYS])]

    def step(state):
        with active_mesh(mesh):
            return train_step(state, *args, STEP_SEED)

    t0 = time.perf_counter()
    state = init_fn()
    state, metrics = step(state)
    loss0 = float(metrics["loss"])
    log(f"init + first step: {time.perf_counter() - t0:.1f}s loss={loss0:.3f}")
    for _ in range(2):  # warm-up
        state, metrics = step(state)
    sync(dev)

    sync_every = int(n_steps if int(sync_every) <= 0 else sync_every)
    t0 = time.perf_counter()
    for i in range(n_steps):
        state, metrics = step(state)
        if (i + 1) % sync_every == 0:
            sync(dev)
    sync(dev)
    wall = time.perf_counter() - t0

    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"bench loss is not finite: {loss}")
    steps_per_s = n_steps / wall
    value = steps_per_s * batch * seconds / n_chips
    flops = analytic_train_flops(cfg, feat_cfg, vocab_size, batch, samples, label_len)
    mfu = flops * steps_per_s / peak_flops(dtype) / n_chips if dev.type == "cuda" else None
    log(f"{n_steps} steps in {wall:.2f}s -> {steps_per_s:.2f} steps/s, {value:.1f} "
        f"audio-s/s/chip (loss={loss:.3f}, {flops / 1e12:.2f} TFLOP/step, MFU "
        f"{'not measured (no card)' if mfu is None else f'{mfu:.1%}'})")
    result = {
        "metric": "train_throughput_audio_seconds_per_sec_per_chip",
        "value": value,
        "unit": "audio-s/s/chip",
        "vs_baseline": None,
        "steps_per_s": steps_per_s,
        "flops_per_step": flops,
        "mfu": mfu,
        "n_chips": n_chips,
        "card": card_of(dev),
    }
    if _return_result:
        return result
    print(json.dumps(result))


def via_trainer_main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,
    ctc_weight: float = 0.3,
    dtype: str = "bfloat16",
    n_batches: int = 120,
    attn_impl: str = "fused",
    fbank_impl: str = "pallas",
    steps_per_dispatch: int = 1,
    corpus_dir: str = os.path.join(ROOT, "build", "bench", "corpus"),
    wire_dtype: str = "int16",
    log_every_iter: int = 50,
    device: str = "cuda",
    **model_overrides,
):
    """Throughput of the real ``Trainer.train_epoch`` (loader with its wav
    IO and prefetch, the int16 wire, device transfer, metric reads at log
    cadence, the throughput meter) on a synthetic corpus of fixed-length
    utterances (one bucket; tone ``seconds / 20`` gives the raw bench's 20
    labels): a pool of at most 640 unique waves, cycled. Epoch 0 warms up;
    epoch 1 is timed wall to wall. Returns the printed result."""
    _no_multi_step(steps_per_dispatch)
    dev = resolve_device(device)
    n_utts = n_batches * batch
    n_unique = min(n_utts, 640)
    paths = make_synth_corpus(
        corpus_dir, n_train=n_unique, n_dev=0, n_test=0,
        seconds_range=(seconds, seconds), tone_sec=seconds / 20.0,
    )
    if n_utts > n_unique:
        with open(paths["train"]) as f:
            rows = f.read().splitlines()
        expanded = os.path.join(corpus_dir, f"train_x{n_utts}.jsonl")
        with open(expanded, "w") as f:
            for i in range(n_utts):
                f.write(rows[i % n_unique] + "\n")
        paths["train"] = expanded
    vocab = Vocab.load(paths["vocab"])
    if vocab.vocab_size != vocab_size:
        raise ValueError(f"corpus vocabulary {vocab.vocab_size} != vocab_size {vocab_size}")

    feat_cfg = FeatureConfig(fbank_impl=fbank_impl)
    cfg = default_config().build(
        ctc_weight=ctc_weight, dtype=dtype, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl, **model_overrides,
    )
    exp_root = tempfile.mkdtemp(prefix="bench_via_trainer_")
    try:
        tcfg = default_train_config().combine(cfg).build(
            spec_augment=True, exp_root=exp_root, exp_name="bench",
            log_every_iter=int(log_every_iter),
            eval_every_iter=1 << 30, save_every_iter=1 << 30,
            num_epoch=2, eval_decode="none",
        )
        model = SpeechTransformer(cfg, vocab.vocab_size,
                                  torch.Generator().manual_seed(0)).to(dev)
        optimizer = make_optimizer(model.parameters(), tcfg, model_width(cfg))
        loader = BucketedLoader(
            paths["train"], vocab, batch_size=batch,
            max_target_len=tcfg.get("max_target_len", 64), wire_dtype=wire_dtype,
        )
        log(f"loader: {len(loader)} batches/epoch, label boundaries "
            f"{loader.label_boundaries}")
        trainer = Trainer(model, optimizer, tcfg, feat_cfg, vocab, train_loader=loader)

        t0 = time.perf_counter()
        trainer.state = trainer.init_fn()
        trainer.train_epoch(0)  # warm-up
        sync(dev)
        log(f"epoch 0 (warm-up): {time.perf_counter() - t0:.1f}s")
        step0 = trainer.state.step
        t0 = time.perf_counter()
        trainer.train_epoch(1)
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(exp_root, ignore_errors=True)
    n_steps_done = trainer.state.step - step0
    if n_steps_done != len(loader):
        raise RuntimeError(f"epoch 1 took {n_steps_done} steps, the loader has {len(loader)}")
    n_chips = trainer.throughput.n_chips
    value = n_steps_done * batch * seconds / wall / n_chips
    steps_per_s = n_steps_done / wall
    label_boundary = next(iter(loader.label_boundaries.values()))
    flops = analytic_train_flops(cfg, feat_cfg, vocab.vocab_size, batch,
                                 int(seconds * feat_cfg.sample_rate), label_boundary)
    mfu = flops * steps_per_s / peak_flops(dtype) / n_chips if dev.type == "cuda" else None
    log(f"epoch 1: {n_steps_done} steps in {wall:.2f}s -> {steps_per_s:.2f} steps/s, "
        f"{value:.1f} audio-s/s/chip (labels at L={label_boundary}); meter: "
        f"{trainer.throughput.audio_seconds_per_sec_per_chip:.1f}")
    result = {
        "metric": "integrated_trainer_throughput_audio_seconds_per_sec_per_chip",
        "value": value,
        "unit": "audio-s/s/chip",
        "vs_baseline": None,
        "steps_per_s": steps_per_s,
        "label_boundary": label_boundary,
        "mfu": mfu,
        "card": card_of(dev),
    }
    print(json.dumps(result))
    return result


def _scaling_rank(n: int, per_chip_batch: int, n_steps: int, device: str, kw: dict) -> dict:
    """One rank of a scaling count: ``main`` on the global batch of n x
    ``per_chip_batch``."""
    return main(batch=per_chip_batch * n, n_chips=n, n_steps=n_steps, device=device,
                _return_result=True, **kw)


def scaling_main(
    per_chip_batch: int = 64,
    chip_counts: str = "",
    n_steps: int = 20,
    device: str = "cuda",
    **kw,
):
    """Weak scaling: a fixed batch a rank, ``main`` in n processes (one per
    card over NCCL; gloo ranks on the CPU) for each count n of
    ``chip_counts`` (default: powers of two up to the cards, or up to
    ``CPU_RANKS`` on the CPU). Prints and returns the table and the
    efficiency of the last count against the first."""
    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else CPU_RANKS
    counts = [int(c) for c in str(chip_counts).split(",") if c] or [
        c for c in (1, 2, 4, 8, 16, 32, 64) if c <= n_dev
    ]
    if dev.type == "cuda" and max(counts) > n_dev:
        raise ValueError(f"chip counts {counts}: this host has {n_dev} card(s); ranks "
                         "sharing a card measure sharing, not scaling")
    from . import bench  # the rank body by its importable name, also under -m

    rows = []
    for n in counts:
        r = run_ranks(n, bench._scaling_rank, n, per_chip_batch, n_steps, device, kw,
                      backend="nccl" if dev.type == "cuda" else "gloo")[0]
        rows.append({"n_chips": n, "audio_s_per_s_per_chip": r["value"],
                     "steps_per_s": r["steps_per_s"], "mfu": r["mfu"]})
        log(f"scaling: {n} chips -> {r['value']} audio-s/s/chip")
    base = rows[0]["audio_s_per_s_per_chip"]
    for r in rows:
        r["efficiency"] = r["audio_s_per_s_per_chip"] / base
    result = {
        "metric": "dp_weak_scaling_efficiency",
        "value": rows[-1]["efficiency"],
        "unit": f"per-chip efficiency at {rows[-1]['n_chips']} chips vs {rows[0]['n_chips']}",
        "vs_baseline": None,
        "per_chip_batch": per_chip_batch,
        "table": rows,
        "card": card_of(dev),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("via_trainer", False):
        via_trainer_main(**kwargs)
    elif kwargs.pop("scaling", False):
        scaling_main(**kwargs)
    else:
        main(**kwargs)
