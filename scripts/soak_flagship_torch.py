#!/usr/bin/env python
"""Flagship-scale synthetic soak of the PyTorch port on one CUDA card.

The port's counterpart of ``scripts/soak_flagship.py``, with its phases,
knobs and defaults:

1. generate the synthetic tone corpus (``utils/synth.py``: 4-8 s
   utterances, vocabulary 4233, 40 tone characters, seed 7);
2. train the flagship through ``python -m asr_chinese_e2e_tpu_torch.main
   train`` (bucketed loader, hybrid CTC/CE, K1-K5, ``eval_decode=joint``,
   cadence checkpoints) and SIGKILL it mid-run;
3. resume with ``--from_ckpt latest`` and train to the end;
4. decode the dev split with ``python -m asr_chinese_e2e_tpu_torch.recognize``
   in ``joint`` and in ``beam`` mode;
5. print (and write to ``summary.json``) the loss and teacher-forced
   accuracy curves, the kill and the resume, the dev evals, the decoded
   CER of each mode and the trainer's audio-s/s.

One deliberate change from the JAX script: the kill trigger. The JAX
script kills 240 s after the first scalars appear; on an H100 that is
well over a thousand steps, which would leave little to resume. This
script kills as soon as the first checkpoint at or past
``SOAK_KILL_STEP`` (default 300) is published in ``index.json``, so the
kill lands at the same place on any card.

Knobs (environment): SOAK_EPOCHS (40), SOAK_WARMUP (150), SOAK_SPECAUG
(false), SOAK_DROPOUT (0.0), SOAK_NORM (pre), SOAK_EVAL_EVERY (300),
SOAK_TRAIN_N (3000), SOAK_FACTOR (1.0), SOAK_TIMEOUT (3600), SOAK_KILL_STEP
(300), SOAK_SEED (0, the trainer's seed; the corpus keeps seed 7),
SOAK_ROOT (``build/soak`` in the repo: corpus, experiment, logs). The
recipe of the JAX record ``artifacts/soak_r4`` (soak A) is

    SOAK_TRAIN_N=10000 SOAK_EPOCHS=16 SOAK_FACTOR=0.25 \
        python scripts/soak_flagship_torch.py

(338-510 s on an H100 80GB HBM3 at 700 W: the corpus, 2.6k steps with
their joint dev evals, two decodes; PERF.md "Trained runs"). The phase
functions take the corpus and experiment paths and extra ``key: value``
words, so a test can drive them with a tiny model on the CPU.
``scripts/soak_ab_torch.py`` runs the recipe's first epochs in A/B arms.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.environ.get("SOAK_ROOT", os.path.join(REPO, "build", "soak"))
EXP_NAME = "soak_flagship"
# The schedule knobs and their reasons are the JAX soak's
# (scripts/soak_flagship.py:35-78): warm_up 150; factor 0.25 for soak A
# (1.0 peaks at 3.6e-3 and plateaus); SpecAugment off on pure tones;
# dropout 0 on this deterministic corpus; pre-LN at this horizon.
NUM_EPOCH = int(os.environ.get("SOAK_EPOCHS", 40))
WARM_UP = int(os.environ.get("SOAK_WARMUP", 150))
SPEC_AUGMENT = os.environ.get("SOAK_SPECAUG", "false")
DROPOUT = os.environ.get("SOAK_DROPOUT", "0.0")
NORM_TYPE = os.environ.get("SOAK_NORM", "pre")
EVAL_EVERY = int(os.environ.get("SOAK_EVAL_EVERY", 300))
TRAIN_N = int(os.environ.get("SOAK_TRAIN_N", 3000))
NOAM_FACTOR = os.environ.get("SOAK_FACTOR", "1.0")
TIMEOUT_S = int(os.environ.get("SOAK_TIMEOUT", 3600))
KILL_STEP = int(os.environ.get("SOAK_KILL_STEP", 300))
SEED = int(os.environ.get("SOAK_SEED", 0))


def log(*a):
    print("[soak]", *a, flush=True)


def words(extra: dict | None) -> list:
    """``{key: value}`` as ``--key value`` words (later words win)."""
    return [w for k, v in (extra or {}).items() for w in (f"--{k}", str(v))]


def gen_corpus(corpus_dir: str, n_train: int = TRAIN_N, n_eval: int = 128,
               seconds_range=(4.0, 8.0)) -> dict:
    sys.path.insert(0, REPO)
    from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus

    t0 = time.time()
    paths = make_synth_corpus(
        corpus_dir, n_train=n_train, n_dev=n_eval, n_test=n_eval,
        n_tone_chars=40, vocab_size=4233,
        seconds_range=seconds_range, tone_sec=0.3, seed=7,
    )
    log(f"corpus ready in {time.time() - t0:.0f}s: {paths}")
    return paths


def train_cmd(paths: dict, exp_root: str, extra: dict | None = None) -> list:
    return [
        sys.executable, "-m", "asr_chinese_e2e_tpu_torch.main", "train",
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", exp_root, "--exp_name", EXP_NAME,
        "--num_epoch", str(NUM_EPOCH), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--attn_impl", "fused", "--fbank_impl", "pallas",
        "--spec_augment", SPEC_AUGMENT,
        "--dropout_rate", DROPOUT,
        "--norm_type", NORM_TYPE,
        "--warm_up", str(WARM_UP), "--noam_factor", NOAM_FACTOR,
        "--log_every_iter", "20", "--eval_every_iter", str(EVAL_EVERY),
        "--save_every_iter", "60",
        "--eval_decode", "joint", "--eval_beam_size", "10",
        "--seed", str(SEED), "--device", "cuda",
    ] + words(extra)


def _tail(path: str, n: int = 25) -> str:
    try:
        with open(path) as f:
            return "\n".join(f.read().splitlines()[-n:])
    except OSError as e:
        return f"<no log: {e}>"


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _step_of(name: str) -> int:
    return int(name.rsplit("_s", 1)[1])


def _count_lines(path: str) -> int:
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for _ in f)


def run_until_killed(cmd: list, exp_dir: str, kill_step: int = KILL_STEP,
                     log_path: str | None = None, poll_s: float = 0.05) -> dict:
    """Run ``cmd``; SIGKILL it as soon as ``index.json`` publishes a
    checkpoint at or past ``kill_step``. Returns ``{"checkpoint", "step",
    "scalar_rows"}`` at the kill. Fails when the child exits before the
    kill or no checkpoint landed."""
    log_path = log_path or os.path.join(os.path.dirname(exp_dir), "soak_phase1.log")
    index = os.path.join(exp_dir, "checkpoints", "index.json")
    scalars = os.path.join(exp_dir, "scalars.jsonl")
    log(f"launch (to be killed at the first checkpoint >= step {kill_step}):",
        " ".join(cmd[1:4]), "...")
    killed = None
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                time.sleep(poll_s)
                idx = _read_json(index)
                if idx and idx.get("latest") and _step_of(idx["latest"]) >= kill_step:
                    proc.send_signal(signal.SIGKILL)
                    killed = idx["latest"]
                    log(f"sent SIGKILL (simulated crash) after {killed} was published")
                    break
            proc.wait()
            rows = _count_lines(scalars)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"phase-1 run exited with {proc.returncode} (killed={killed is not None})")
    if killed is None:
        # the child finished (or crashed) before the kill fired: a resume
        # would continue a completed run and void the crash test
        print(_tail(log_path), flush=True)
        raise SystemExit(
            f"phase-1 exited rc={proc.returncode} before the SIGKILL: raise "
            f"SOAK_EPOCHS or lower SOAK_KILL_STEP (log: {log_path})"
        )
    idx = _read_json(index)
    if not idx or not idx.get("latest"):
        print(_tail(log_path), flush=True)
        raise SystemExit("no checkpoint landed before the kill (log tail above)")
    return {"checkpoint": idx["latest"], "step": _step_of(idx["latest"]),
            "scalar_rows": rows, **_saved_state(exp_dir, idx["latest"])}


def _saved_state(exp_dir: str, name: str) -> dict:
    """The epoch and the optimizer's update count (the Noam schedule's)
    that checkpoint ``name`` holds, read before the resumed run's
    retention policy may delete it."""
    import torch

    path = os.path.join(exp_dir, "checkpoints", name)
    blob = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                      weights_only=True)
    return {"epoch": int(_read_json(os.path.join(path, "meta.json"))["epoch"]),
            "optimizer_count": int(blob["optimizer"]["count"])}


def run_to_completion(cmd: list, log_path: str, timeout_s: int = TIMEOUT_S) -> None:
    log("run to completion:", " ".join(cmd[-2:]))
    with open(log_path, "w") as out:
        proc = subprocess.run(cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                              timeout=timeout_s)
    print(_tail(log_path), flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"run failed rc={proc.returncode} (log: {log_path})")


def decode(paths: dict, exp_dir: str, mode: str, out: str,
           extra: dict | None = None) -> float:
    """``recognize`` the dev split in ``mode``; returns its CER (%)."""
    idx = _read_json(os.path.join(exp_dir, "checkpoints", "index.json"))
    which = "best" if idx.get("best") else "latest"
    cmd = [
        sys.executable, "-m", "asr_chinese_e2e_tpu_torch.recognize",
        "--exp", exp_dir, "--vocab", paths["vocab"], "--manifest", paths["dev"],
        "--mode", mode, "--beam_size", "10", "--batch_size", "64",
        "--max_seconds", "8.0", "--which", which, "--out", out, "--device", "cuda",
    ] + words(extra)
    log(f"decode: mode={mode} which={which}")
    proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, timeout=3600)
    print("\n".join(proc.stdout.splitlines()[-8:]), flush=True)
    if proc.returncode != 0:
        raise SystemExit(f"decode failed rc={proc.returncode}")
    with open(out) as f:
        return json.load(f).get("cer")


def _accuracy(row: dict) -> float:
    return row["train/n_correct"] / max(row["train/n_word"], 1.0)


def summarize(exp_dir: str, kill: dict) -> dict:
    """Curves, the kill and the resume, the dev evals and the throughput
    from ``scalars.jsonl``; checks that the resume continued the run."""
    sys.path.insert(0, REPO)
    from asr_chinese_e2e_tpu_torch.core.config import Config
    from asr_chinese_e2e_tpu_torch.train.optimizer import current_lr, model_width

    rows = [json.loads(line) for line in open(os.path.join(exp_dir, "scalars.jsonl"))]
    before, after = rows[: kill["scalar_rows"]], rows[kill["scalar_rows"]:]
    train_before = [r for r in before if "train/loss" in r]
    train_after = [r for r in after if "train/loss" in r]
    if not train_after:
        raise SystemExit("the resumed run logged no train step")
    cfg = Config.load(os.path.join(exp_dir, "config.json"))
    first = train_after[0]
    log_every = int(cfg.log_every_iter)
    resume = {
        "checkpoint": kill["checkpoint"],
        "saved_step": kill["step"],
        "saved_epoch": kill["epoch"],
        "optimizer_count": kill["optimizer_count"],
        "last_logged_step_before_kill": train_before[-1]["step"] if train_before else None,
        "last_tf_accuracy_before_kill": _accuracy(train_before[-1]) if train_before else None,
        "first_logged_step_after_resume": first["step"],
        "first_lr_after_resume": first["lr"],
        "current_lr_there": current_lr(cfg, model_width(cfg), first["step"]),
        "first_tf_accuracy_after_resume": _accuracy(first),
    }
    if resume["optimizer_count"] != kill["step"]:
        raise SystemExit(f"optimizer count {resume['optimizer_count']} != step {kill['step']}")
    want_first = (kill["step"] // log_every + 1) * log_every
    if first["step"] != want_first:
        raise SystemExit(f"resumed at step {first['step']}, want {want_first}")
    if abs(first["lr"] - resume["current_lr_there"]) > 1e-12:
        raise SystemExit("the resumed lr is not current_lr at its step")
    train = train_before + train_after
    acc = [(r["step"], round(_accuracy(r), 4)) for r in train if "train/n_word" in r]
    dev = [(r["step"], r.get("dev/loss"), r.get("dev/decoded_cer"))
           for r in rows if "dev/loss" in r]
    tput = [r["train/audio_s_per_s_per_chip"] for r in train]
    idx = _read_json(os.path.join(exp_dir, "checkpoints", "index.json"))
    out = {
        "loss": [(r["step"], round(r["train/loss"], 4)) for r in train],
        "tf_accuracy": acc,
        "dev": dev,
        "resume": resume,
        "audio_s_per_s_last": tput[-1],
        "audio_s_per_s_median": sorted(tput)[len(tput) // 2],
        "checkpoints": {k: idx[k] for k in ("latest", "best", "best_metric")},
    }
    log("train TF token accuracy (every ~10th log):", acc[::10], "last:", acc[-1])
    log("train/loss curve:", out["loss"])
    log("dev evals (step, loss, decoded_cer):", dev)
    log("resume:", json.dumps(resume))
    log(f"integrated throughput (last): {tput[-1]:.1f} audio-s/s")
    log("checkpoints:", out["checkpoints"])
    return out


def _require_cuda() -> None:
    import torch

    # before anything is written: the soak runs the port on the card
    if not torch.cuda.is_available():
        print("CUDA is not available: the soak trains on the card", file=sys.stderr)
        raise SystemExit(2)


def main() -> None:
    import shutil

    _require_cuda()
    exp_root = os.path.join(ROOT, "exp")
    exp_dir = os.path.join(exp_root, EXP_NAME)
    shutil.rmtree(exp_dir, ignore_errors=True)
    os.makedirs(exp_root, exist_ok=True)
    t0 = time.time()
    paths = gen_corpus(os.path.join(ROOT, f"corpus{TRAIN_N}"))
    kill = run_until_killed(train_cmd(paths, exp_root), exp_dir,
                            log_path=os.path.join(ROOT, "soak_phase1.log"))
    log("latest checkpoint at kill:", kill["checkpoint"])
    run_to_completion(train_cmd(paths, exp_root, {"from_ckpt": "latest"}),
                      os.path.join(ROOT, "soak_phase2.log"))
    summary = summarize(exp_dir, kill)
    summary["cer"] = {
        mode: decode(paths, exp_dir, mode, os.path.join(ROOT, f"soak_decode_{mode}.json"))
        for mode in ("joint", "beam")
    }
    summary["wall_s"] = time.time() - t0
    summary["knobs"] = {
        "train_n": TRAIN_N, "epochs": NUM_EPOCH, "warm_up": WARM_UP,
        "noam_factor": NOAM_FACTOR, "dropout": DROPOUT, "norm": NORM_TYPE,
        "spec_augment": SPEC_AUGMENT, "eval_every": EVAL_EVERY,
        "kill_step": KILL_STEP, "seed": SEED,
    }
    with open(os.path.join(ROOT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    log(f"DONE: dev decoded CER joint={summary['cer']['joint']} "
        f"beam={summary['cer']['beam']} in {summary['wall_s']:.0f}s")
    first, last = summary["loss"][0][1], summary["loss"][-1][1]
    if not last < first:
        raise SystemExit(f"loss did not decrease: {first} -> {last}")


if __name__ == "__main__":
    main()
