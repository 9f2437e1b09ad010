#!/usr/bin/env python
"""Streaming flagship of the PyTorch port on trained weights, on one CUDA
card: the port's counterpart of ``scripts/soak_streaming.py``.

Train a causal-banded streaming flagship on the synthetic corpus, then
drive the port's ``StreamingRecognizer`` over the dev set, incremental on
and off, and show

  1. incremental finals == the prefix re-encode (offline) recognizer's
     finals, required in f32 (the same checkpoint loaded in float32) and
     counted in bf16;
  2. the decoded CER of those finals (the streaming model learned);
  3. the partial latency with trained weights.

    python scripts/soak_streaming_torch.py              # all: corpus, train, eval
    python scripts/soak_streaming_torch.py eval [modes] # eval only (joint ctc_greedy)

Recipe (``scripts/soak_streaming.py:82-110``): flagship 512d/8h/6+6L bf16,
causal encoder, attention band 50 (K6/K7 with ``ASR_BANDED_WINDOW=1``),
fixed global CMVN from 64 training utterances, pre-LN, dropout 0, Noam
factor 0.25, warm-up 150, 16 epochs (SOAK_EPOCHS) of the 10k-utterance
corpus. SOAK_ROOT (``build/soak`` in the repo) holds the corpus (shared
with ``soak_flagship_torch.py`` at SOAK_TRAIN_N=10000), the experiment and
the eval JSONs. 532 s on an H100 80GB HBM3 at 700 W with the corpus
already made (PERF.md "Trained runs").
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
ROOT = os.environ.get("SOAK_ROOT", os.path.join(REPO, "build", "soak"))
CORPUS = os.path.join(ROOT, "corpus10000")
EXP_ROOT = os.path.join(ROOT, "stream_exp")
EXP_NAME = "stream_flagship"
BAND = 50
EPOCHS = int(os.environ.get("SOAK_EPOCHS", 16))
CHUNK = 2000  # samples a feed: 125 ms


def log(*a):
    print("[stream-soak]", *a, flush=True)


def gen_corpus(corpus_dir: str = CORPUS) -> dict:
    from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus

    return make_synth_corpus(
        corpus_dir, n_train=10000, n_dev=128, n_test=128,
        n_tone_chars=40, vocab_size=4233,
        seconds_range=(4.0, 8.0), tone_sec=0.3, seed=7,
    )


def cmvn_stats(paths: dict, n: int = 64, device: str = "cuda") -> tuple:
    """Global log-mel mean / std over the first ``n`` training utterances,
    each alone through the fbank kernel (its plain version on the CPU):
    the FIXED CMVN that causal featurization needs."""
    import numpy as np
    import torch

    from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
    from asr_chinese_e2e_tpu_torch.data.io import load_wav
    from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel

    cfg = FeatureConfig(fbank_impl="pallas")
    rows = [json.loads(line) for line in open(paths["train"])][:n]
    vals = []
    for r in rows:
        w = torch.from_numpy(load_wav(r["wave"]).astype(np.float32) / 32768.0)
        feats = log_mel_spectrogram_kernel(w[None].to(device), cfg)
        vals.append(feats[0].double().cpu())
    allv = torch.cat(vals, dim=0)
    return float(allv.mean()), float(allv.std(unbiased=False))


def train_cmd(paths: dict, mean: float, std: float, exp_root: str = EXP_ROOT,
              extra: dict | None = None) -> list:
    cmd = [
        sys.executable, "-m", "asr_chinese_e2e_tpu_torch.main", "train",
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", exp_root, "--exp_name", EXP_NAME,
        "--num_epoch", str(EPOCHS), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--attn_impl", "fused", "--fbank_impl", "pallas",
        "--spec_augment", "false", "--dropout_rate", "0.0",
        "--norm_type", "pre", "--warm_up", "150", "--noam_factor", "0.25",
        "--causal_encoder", "true", "--attention_band", str(BAND),
        "--cmvn_mode", "fixed", "--cmvn_mean", f"{mean:.6f}",
        "--cmvn_std", f"{std:.6f}",
        "--log_every_iter", "20", "--eval_every_iter", "400",
        "--save_every_iter", "300",
        "--eval_decode", "joint", "--eval_beam_size", "10",
        "--device", "cuda",
    ]
    return cmd + [w for k, v in (extra or {}).items() for w in (f"--{k}", str(v))]


def train(paths: dict, mean: float, std: float, log_path: str) -> None:
    cmd = train_cmd(paths, mean, std)
    log("train:", " ".join(cmd[-16:]))
    t0 = time.time()
    # the windowed kernels K6/K7 serve the band (read at every call)
    env = {**os.environ, "ASR_BANDED_WINDOW": "1"}
    with open(log_path, "w") as out:
        proc = subprocess.run(cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                              timeout=10800, env=env)
    log(f"train rc={proc.returncode} in {time.time() - t0:.0f}s (log {log_path})")
    if proc.returncode != 0:
        print("\n".join(open(log_path).read().splitlines()[-30:]))
        raise SystemExit("train failed")


def _models(exp: str, vocab_path: str, device: str) -> tuple:
    """The best checkpoint as trained (bf16) and the same weights in f32."""
    import torch

    from asr_chinese_e2e_tpu_torch.core.config import Config
    from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
    from asr_chinese_e2e_tpu_torch.utils.experiment import checkpoint_path, load_experiment

    model, cfg, feat_cfg, vocab = load_experiment(exp, vocab_path, "best", device=device)
    path = checkpoint_path(exp, "best")
    if not os.path.exists(path):
        path = checkpoint_path(exp, "latest")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model32 = SpeechTransformer(Config(**{**cfg.to_dict(), "dtype": "float32"}),
                                vocab.vocab_size)
    model32.load_state_dict(blob["state_dict"])
    return {"bfloat16": model, "float32": model32.to(device).eval()}, feat_cfg, vocab


def _serve(rec, rows: list) -> tuple:
    """Each dev wav as its own stream in 125 ms feeds; returns (texts,
    partials emitted, wall seconds of the feeds that emitted a partial)."""
    import numpy as np

    from asr_chinese_e2e_tpu_torch.data.io import load_wav

    texts, partials, lat = [], 0, []
    for r in rows:
        # the corpus has no inter-utterance silence for the gate to close on
        rec.reset_stream()
        w = load_wav(r["wave"], dtype=np.int16)
        finals = []
        for i in range(0, len(w), CHUNK):
            t0 = time.perf_counter()
            evs = rec.feed(w[i : i + CHUNK])
            dt = time.perf_counter() - t0
            for e in evs:
                if e.kind == "final":
                    finals.append(e.text)
                else:
                    partials += 1
                    lat.append(dt)
        finals += [e.text for e in rec.finish() if e.kind == "final"]
        # Event.text is space-joined tokens; CER runs on plain strings
        texts.append("".join(finals).replace(" ", ""))
    return texts, partials, lat


def eval_phase(mode: str = "joint", exp: str | None = None,
               corpus: str = CORPUS, out_dir: str | None = None,
               device: str = "cuda") -> dict:
    """Incremental vs prefix re-encode recognizers over the dev set with
    the trained checkpoint, in bf16 and in f32; writes ``eval_{mode}.json``
    (the JAX script's fields, plus ``f32_*``). Fails when an f32
    incremental final differs from the prefix re-encode's."""
    import numpy as np

    from asr_chinese_e2e_tpu_torch.decode.cer import corpus_cer
    from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer

    exp = exp or os.path.join(EXP_ROOT, EXP_NAME)
    out_dir = out_dir or ROOT
    models, feat_cfg, vocab = _models(exp, os.path.join(corpus, "vocab.json"), device)
    rows = [json.loads(line) for line in open(os.path.join(corpus, "dev.jsonl"))]
    refs = [r["tgt"] for r in rows]
    log(f"eval: {len(rows)} dev utts, mode={mode}")
    out = {"mode": mode, "dev_utts": len(rows)}
    for dtype, prefix in (("bfloat16", ""), ("float32", "f32_")):
        runs = {}
        for inc in ("on", "off"):
            rec = StreamingRecognizer(
                models[dtype], vocab, feat_cfg, mode=mode, incremental=inc,
                beam_size=10, max_len=40,
            )
            t0 = time.time()
            runs[inc] = _serve(rec, rows) + (time.time() - t0,)
        (inc_texts, inc_partials, inc_lat, inc_wall), (off_texts, _, _, off_wall) = (
            runs["on"], runs["off"])
        match = sum(a == b for a, b in zip(inc_texts, off_texts))
        lat_ms = np.asarray(inc_lat[3:]) * 1e3  # the first feeds warm up
        out.update({
            f"{prefix}incremental_cer": round(corpus_cer(inc_texts, refs), 3),
            f"{prefix}offline_recognizer_cer": round(corpus_cer(off_texts, refs), 3),
            f"{prefix}finals_match": f"{match}/{len(rows)}",
            f"{prefix}partials_emitted": inc_partials,
            f"{prefix}partial_ms_mean": round(float(lat_ms.mean()), 3) if len(lat_ms) else None,
            f"{prefix}partial_ms_p95": (round(float(np.percentile(lat_ms, 95)), 3)
                                        if len(lat_ms) else None),
            f"{prefix}inc_wall_s": round(inc_wall, 1),
            f"{prefix}off_wall_s": round(off_wall, 1),
        })
        log(f"{dtype} {mode}: {match} of {len(rows)} incremental finals equal "
            "the prefix re-encode finals")
    log("RESULT", json.dumps(out))
    with open(os.path.join(out_dir, f"eval_{mode}.json"), "w") as f:
        json.dump(out, f, indent=2)
    if out["f32_finals_match"] != f"{len(rows)}/{len(rows)}":
        raise SystemExit(f"f32 {mode}: incremental finals differ from the prefix "
                         f"re-encode's ({out['f32_finals_match']})")
    return out


def _require_cuda() -> None:
    import torch

    # before anything is written: the soak runs the port on the card
    if not torch.cuda.is_available():
        print("CUDA is not available: the soak trains on the card", file=sys.stderr)
        raise SystemExit(2)


def main() -> None:
    _require_cuda()
    phase = sys.argv[1] if len(sys.argv) > 1 else "all"
    if phase == "eval":
        # the prefix re-encode through the windowed kernels K6 (read at every call)
        os.environ["ASR_BANDED_WINDOW"] = "1"
        for mode in (sys.argv[2:] or ["joint", "ctc_greedy"]):
            eval_phase(mode)
        return
    os.makedirs(EXP_ROOT, exist_ok=True)
    paths = gen_corpus()
    mean, std = cmvn_stats(paths)
    log(f"fixed CMVN: mean={mean:.6f} std={std:.6f}")
    train(paths, mean, std, os.path.join(ROOT, "stream_train.log"))
    # the eval in its own process, as the JAX script runs it
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "eval"],
                          cwd=REPO, timeout=7200)
    raise SystemExit(proc.returncode)


if __name__ == "__main__":
    main()
