#!/usr/bin/env python
"""Post-LN flagship sweep of the port on one CUDA card (the port of
``scripts/sweep_postln.py``): the reference's placement and
regularisation (post-LN, label smoothing 0.1) at the flagship soak's
scale (the 10k-utterance tone corpus, 16 epochs, ~2.5k steps), with the
warm-up stretched so that the Noam peak (0.4 x 512^-0.5 x 700^-0.5 =
6.7e-4, the reference recipe's) arrives near step 700:

  b1: dropout 0.1            b2: dropout 0.0
  b3: dropout 0.1, deepnorm  b4: dropout 0.1, 32 epochs

Each arm is one ``python -m asr_chinese_e2e_tpu_torch.main train``
process (the flagship recipe's kernels: bf16, fused attention, fbank
kernel, CTC 0.3, ``eval_decode=joint``), run one after another. Scalars go
to ``<SWEEP_ROOT>/<arm>/scalars.jsonl``, logs to ``<SWEEP_ROOT>/<arm>.log``,
the summary (teacher-forced accuracy curve, last CE, dev decoded CER at
each eval) to ``<SWEEP_ROOT>/summary.json``.

    python3 scripts/sweep_postln_torch.py b1 b2      (arm names; b1 b2 by default)

Knobs (environment): SWEEP_EPOCHS (16), SWEEP_TIMEOUT (7200 s an arm),
SWEEP_ROOT (``build/sweep_postln`` in the repo). The corpus is the soaks'
(``<SOAK_ROOT>/corpus10000``, made once).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import soak_flagship_torch as soak  # noqa: E402

REPO = soak.REPO
ROOT = os.environ.get("SWEEP_ROOT", os.path.join(REPO, "build", "sweep_postln"))
NUM_EPOCH = int(os.environ.get("SWEEP_EPOCHS", 16))
TIMEOUT_S = int(os.environ.get("SWEEP_TIMEOUT", 7200))

COMMON = {"norm_type": "post", "label_smoothing": 0.1, "warm_up": 700, "noam_factor": 0.4}
ARMS = {
    "b1": {**COMMON, "dropout_rate": 0.1},
    "b2": {**COMMON, "dropout_rate": 0.0},
    "b3": {**COMMON, "dropout_rate": 0.1, "deepnorm": "true"},
    # the longer horizon (32 epochs, ~5k steps)
    "b4": {**COMMON, "dropout_rate": 0.1, "num_epoch": 32},
}


def log(*a):
    print("[sweep]", *a, flush=True)


def arm_cmd(name: str, paths: dict) -> list:
    return [
        sys.executable, "-m", "asr_chinese_e2e_tpu_torch.main", "train",
        "--train_manifest", paths["train"],
        "--dev_manifest", paths["dev"],
        "--test_manifest", paths["test"],
        "--vocab_path", paths["vocab"],
        "--exp_root", ROOT, "--exp_name", name,
        "--num_epoch", str(NUM_EPOCH), "--batch_size", "64",
        "--ctc_weight", "0.3", "--dtype", "bfloat16",
        "--attn_impl", "fused", "--fbank_impl", "pallas",
        "--spec_augment", "false",
        "--log_every_iter", "20", "--eval_every_iter", "300",
        "--save_every_iter", "300",
        "--eval_decode", "joint", "--eval_beam_size", "10",
        "--device", "cuda",
    ] + soak.words(ARMS[name])


def run_arm(name: str, paths: dict) -> dict:
    shutil.rmtree(os.path.join(ROOT, name), ignore_errors=True)
    log(f"arm {name}: {ARMS[name]}")
    t0 = time.time()
    with open(os.path.join(ROOT, f"{name}.log"), "w") as out:
        proc = subprocess.run(arm_cmd(name, paths), cwd=REPO, stdout=out,
                              stderr=subprocess.STDOUT, timeout=TIMEOUT_S)
    log(f"arm {name} rc={proc.returncode} in {time.time() - t0:.0f}s")
    return summarize(name, os.path.join(ROOT, name, "scalars.jsonl"))


def summarize(name: str, scalars: str) -> dict:
    """The teacher-forced accuracy curve (about 12 points), the last CE and
    the dev decoded CER at each evaluation of one arm's ``scalars.jsonl``."""
    with open(scalars) as f:
        rows = [json.loads(line) for line in f]
    acc = [(r["step"], round(soak._accuracy(r), 3)) for r in rows if "train/n_word" in r]
    ce = [(r["step"], round(r.get("train/ce_loss", r["train/loss"]), 3))
          for r in rows if "train/loss" in r]
    dev = [(r["step"], r.get("dev/decoded_cer")) for r in rows if "dev/loss" in r]
    out = {
        "arm": name,
        "steps": acc[-1][0] if acc else 0,
        "tf_acc_curve": acc[:: max(1, len(acc) // 12)],
        "tf_acc_last": acc[-1][1] if acc else None,
        "ce_last": ce[-1][1] if ce else None,
        "dev_cer": dev,
    }
    log(json.dumps(out))
    return out


def main() -> None:
    soak._require_cuda()
    arms = sys.argv[1:] or ["b1", "b2"]
    unknown = [a for a in arms if a not in ARMS]
    if unknown:
        raise SystemExit(f"unknown arms {unknown}; known: {sorted(ARMS)}")
    os.makedirs(ROOT, exist_ok=True)
    paths = soak.gen_corpus(os.path.join(soak.ROOT, "corpus10000"), n_train=10000)
    results = [run_arm(a, paths) for a in arms]
    with open(os.path.join(ROOT, "summary.json"), "w") as f:
        json.dump(results, f, indent=2)
    log("SWEEP DONE")
    for r in results:
        log(f"{r['arm']}: steps={r['steps']} tf_acc={r['tf_acc_last']} ce={r['ce_last']} "
            f"dev_cer_last={r['dev_cer'][-1] if r['dev_cer'] else None}")


if __name__ == "__main__":
    main()
