#!/usr/bin/env python
"""Beam-search decode throughput of the port on the flagship decoder, on one
H100 unless the caller asks for the CPU (the port of
``scripts/bench_decode.py``).

- ``main``: 64 random 8 s waves (seed 0, as the JAX bench draws them),
  beam 10, max_len 40, bf16, dropout 0. Features once through the fbank
  kernel K5 (``fbank_impl="pallas"``, as the serving path computes them;
  the JAX bench runs its XLA fbank, outside its timed window as here),
  one encode (K1 six times: ``attn_impl="fused"``, the port's serving
  attention, where the JAX bench keeps its XLA attention), then for each
  mode one warm search and ``n_iters`` timed: ``lazy``
  (``beam_search(lazy=True)``: the self-attention caches stay in place and
  an ancestry map routes each step), ``gather`` (``lazy=False``: the
  caches are gathered by parent each step) and ``joint``
  (``joint_beam_search``, ctc_weight 0.3; K8 once a decode step). Each
  timed search ends in ``torch.cuda.synchronize`` in place of the JAX
  bench's ``BeamResult.materialize`` (not ported: ROADMAP item 9). Prints
  ms per batch and audio-s/s per mode.
- ``corpus``: decode wall throughput through the port's ``recognize``
  (manifest -> bucketed int16 batches -> wav reads -> K5 -> encoder ->
  search -> n-best), an untrained flagship experiment saved with the
  port's ``CheckpointManager`` (throughput does not depend on the
  weights): one warm pass, then a timed pass over ``n_batches`` x
  ``batch`` utterances; wall audio-s/s and ``recognize``'s ``encode_s`` /
  ``search_s``.
- ``sweep``: ``corpus`` for each (mode, pipeline_depth) pair in one
  process.

    python3 scripts/bench_decode_torch.py [--batch 64 --beam 10 --modes lazy,gather,joint]
    python3 scripts/bench_decode_torch.py --corpus true [--mode joint --pipeline_depth 1]
    python3 scripts/bench_decode_torch.py --sweep true [--modes beam,joint --depths 0,1]

``--device cpu`` with tiny widths (``--d_model 16 --num_heads 2 ...``)
runs the plain versions. Each run ends with one JSON line of its numbers
and the card (``nvidia-smi``'s name and power limit). The kernels are
built from the checkout at first use.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from asr_chinese_e2e_tpu_torch.bench import card_of, resolve_device, sync  # noqa: E402
from asr_chinese_e2e_tpu_torch.core.config import Config  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig, parse_batch  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.joint import joint_beam_search  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import (  # noqa: E402
    SpeechTransformer,
    default_config,
)
from asr_chinese_e2e_tpu_torch.recognize import recognize  # noqa: E402
from asr_chinese_e2e_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from asr_chinese_e2e_tpu_torch.train.optimizer import (  # noqa: E402
    default_train_config,
    make_optimizer,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402

BUILD = os.path.join(REPO, "build", "bench")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def serving_config(dtype: str = "bfloat16", **overrides) -> tuple:
    """(model config, feature config) of the flagship as the serving path
    runs it: CTC 0.3, dropout 0, the fused attention (K1) and the fbank
    kernel (K5)."""
    feat_cfg = FeatureConfig(fbank_impl="pallas")
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, input_dim=feat_cfg.feature_dim, dropout_rate=0.0,
        attn_impl="fused", **overrides,
    )
    return Config(**cfg.to_dict()), feat_cfg


def serving_model(cfg, vocab_size: int, dev: torch.device):
    """The flagship with weights from seed 0, cast to its compute dtype as
    ``load_experiment`` casts it, in eval mode."""
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0)).to(dev)
    return model.to(dtype=model.compute_dtype).eval()


def encoded_batch(model, feat_cfg, batch: int, seconds: float, dev: torch.device) -> tuple:
    """(enc_out, enc_lens) of ``batch`` random waves of ``seconds`` (the JAX
    bench's draw: seed 0, float32 ``randn * 0.1``)."""
    rng = np.random.RandomState(0)
    samples = int(seconds * feat_cfg.sample_rate)
    wave = torch.from_numpy(rng.randn(batch, samples).astype(np.float32) * 0.1).to(dev)
    lens = torch.full((batch,), samples, dtype=torch.int32, device=dev)
    with torch.inference_mode():
        feats, feat_lens = parse_batch(wave, lens, feat_cfg)
        return model.encode(feats, feat_lens)


def searches(model, enc_out, enc_lens, beam: int, max_len: int) -> dict:
    """The timed searches by mode."""
    return {
        "lazy": lambda: beam_search(model, enc_out, enc_lens, beam, max_len, lazy=True),
        "gather": lambda: beam_search(model, enc_out, enc_lens, beam, max_len, lazy=False),
        "joint": lambda: joint_beam_search(model, enc_out, enc_lens, beam, max_len,
                                           ctc_weight=0.3),
    }


def main(
    seconds: float = 8.0,
    batch: int = 64,
    vocab_size: int = 4233,
    beam: int = 10,
    max_len: int = 40,
    dtype: str = "bfloat16",
    n_iters: int = 5,
    modes: str = "lazy,gather,joint",
    device: str = "cuda",
    **model_overrides,
) -> dict:
    """Per mode: ms per batch, audio-s/s, the first search's seconds and
    the last search's tokens and scores (host numpy)."""
    dev = resolve_device(device)
    card = card_of(dev)
    print(f"card: {card}", flush=True)
    cfg, feat_cfg = serving_config(dtype, **model_overrides)
    model = serving_model(cfg, vocab_size, dev)
    t0 = time.perf_counter()
    enc_out, enc_lens = encoded_batch(model, feat_cfg, batch, seconds, dev)
    sync(dev)
    log(f"enc_out {tuple(enc_out.shape)} {enc_out.dtype}: {time.perf_counter() - t0:.2f}s")
    by_mode = searches(model, enc_out, enc_lens, beam, max_len)
    out = {}
    for mode in modes.split(","):
        search = by_mode[mode]
        t0 = time.perf_counter()
        r = search()
        sync(dev)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n_iters):
            r = search()
            sync(dev)
        wall = (time.perf_counter() - t0) / n_iters
        r.materialize()
        tput = batch * seconds / wall
        out[mode] = {"ms_per_batch": wall * 1e3, "audio_s_per_s": tput, "first_s": first_s,
                     "tokens": r.tokens, "scores": r.scores}
        print(f"[{mode}] {wall * 1e3:.1f} ms/batch = {tput:.0f} audio-s/s/chip (first "
              f"{first_s:.2f}s, best score {r.scores[0, 0]:.2f})", flush=True)
    print(json.dumps({"bench": "decode", "card": card, "batch": batch, "beam": beam,
                      "max_len": max_len, "modes": {
                          m: {k: v for k, v in r.items() if k in ("ms_per_batch", "audio_s_per_s")}
                          for m, r in out.items()}}))
    return out


def _untrained_experiment(exp_dir: str, vocab_path: str, dtype: str, **overrides) -> None:
    """An untrained flagship experiment at ``exp_dir`` (``config.json`` with
    the train and model keys, a checkpoint through ``CheckpointManager``,
    which exports ``torch_checkpoints/best.pt``); kept when its config is
    the same."""
    vocab = Vocab.load(vocab_path)
    cfg, feat_cfg = serving_config(dtype, fbank_impl="pallas", **overrides)
    tcfg = default_train_config().combine(cfg).build(n_mels=feat_cfg.n_mels)
    cfg_path = os.path.join(exp_dir, "config.json")
    if os.path.exists(cfg_path) and Config.load(cfg_path).to_dict() == tcfg.to_dict():
        return
    model = SpeechTransformer(cfg, vocab.vocab_size, torch.Generator().manual_seed(0))
    optimizer = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, _, _ = make_step_fns(model, optimizer, feat_cfg, tcfg)
    os.makedirs(exp_dir, exist_ok=True)
    mgr = CheckpointManager(os.path.join(exp_dir, "checkpoints"), export_dir=exp_dir)
    mgr.save(init_fn(), epoch=0, config=cfg, vocab_fingerprint=vocab.fingerprint(), metric=1.0)
    tcfg.save(cfg_path)  # last: a cut save leaves no config to reuse


def corpus(
    seconds: float = 8.0,
    batch: int = 64,
    beam: int = 10,
    max_len: int = 40,
    mode: str = "joint",
    n_batches: int = 12,
    pipeline_depth: int = 1,
    corpus_dir: str = os.path.join(BUILD, "corpus"),
    exp_dir: str = os.path.join(BUILD, "decode_exp"),
    dtype: str = "bfloat16",
    device: str = "cuda",
    **model_overrides,
) -> dict:
    """Corpus decode wall throughput through ``recognize`` (its per-
    utterance lines go to a null sink); returns the timed pass's numbers and
    its ``utts`` (keyed by wav name: a cycled row is one key)."""
    dev = resolve_device(device)
    n_utts = n_batches * batch
    n_unique = min(n_utts, 640)
    paths = make_synth_corpus(
        corpus_dir, n_train=n_unique, n_dev=0, n_test=0,
        seconds_range=(seconds, seconds), tone_sec=seconds / 20.0,
    )
    manifest = paths["train"]
    if n_utts > n_unique:
        with open(manifest) as f:
            rows = f.read().splitlines()
        manifest = os.path.join(corpus_dir, f"decode_x{n_utts}.jsonl")
        with open(manifest, "w") as f:
            for i in range(n_utts):
                f.write(rows[i % n_unique] + "\n")
    _untrained_experiment(exp_dir, paths["vocab"], dtype, **model_overrides)
    kw = dict(exp=exp_dir, vocab=paths["vocab"], manifest=manifest, mode=mode,
              beam_size=beam, max_decode_len=max_len, batch_size=batch,
              max_seconds=seconds, pipeline_depth=pipeline_depth, device=str(dev))
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        t0 = time.perf_counter()
        recognize(**kw)  # loads the experiment, warms the caches
        log(f"[corpus warm-up] {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        res = recognize(**kw)
        wall = time.perf_counter() - t0
    timing = res["timing"]
    tput = timing["audio_s"] / wall
    print(f"[corpus mode={mode} depth={pipeline_depth}] {n_utts} utts in "
          f"{wall:.2f}s = {tput:.0f} audio-s/s/chip wall ({wall / n_batches * 1e3:.0f} "
          f"ms/batch; encode {timing['encode_s']:.3f}s, search {timing['search_s']:.3f}s)",
          flush=True)
    return {"mode": mode, "pipeline_depth": pipeline_depth, "n_utts": n_utts,
            "wall_s": wall, "audio_s_per_s": tput, "encode_s": timing["encode_s"],
            "search_s": timing["search_s"], "card": card_of(dev), "utts": res["utts"]}


def sweep(
    seconds: float = 8.0,
    batch: int = 64,
    beam: int = 10,
    max_len: int = 40,
    n_batches: int = 12,
    modes: str = "beam,joint",
    depths: str = "0,1",
    **kw,
) -> list:
    """``corpus`` for each (mode, pipeline_depth) pair in one process (one
    experiment load, warm caches across depths)."""
    rows = [corpus(seconds=seconds, batch=batch, beam=beam, max_len=max_len, mode=mode,
                   n_batches=n_batches, pipeline_depth=int(depth), **kw)
            for mode in modes.split(",") for depth in str(depths).split(",")]
    print(json.dumps({"bench": "decode_sweep", "rows": [
        {k: v for k, v in r.items() if k != "utts"} for r in rows]}))
    return rows


if __name__ == "__main__":
    from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("corpus", False):
        r = corpus(**kwargs)
        print(json.dumps({"bench": "decode_corpus",
                          **{k: v for k, v in r.items() if k != "utts"}}))
    elif kwargs.pop("sweep", False):
        sweep(**kwargs)
    else:
        main(**kwargs)
