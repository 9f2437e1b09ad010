#!/usr/bin/env python
"""A/B of the flagship soak's first epochs on one CUDA card: the recipe of
``scripts/soak_flagship_torch.py`` (its knobs, corpus and subprocess
trainer) in each arm of ``AB_ARMS``, each on the same batches in the same
order, the curves printed side by side and written to
``<SOAK_ROOT>/ab.json``.

    SOAK_TRAIN_N=10000 SOAK_EPOCHS=16 SOAK_FACTOR=0.25 \
        python scripts/soak_ab_torch.py [arm ...]

(all arms by default; 213 s for the five on an H100 80GB HBM3 at 700 W,
PERF.md "Trained runs"). It asks whether a slow soak is the init's draw
or a kernel: the plain CTC recursion and the plain attention against the
recipe, a second seed, f32.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import soak_flagship_torch as soak  # noqa: E402

# the recipe, then one selection changed each
AB_ARMS = {
    "recipe": {},
    "seed1": {"seed": 1},
    "ctc_scan": {"ctc_impl": "scan"},
    "attn_xla": {"attn_impl": "xla"},
    "float32": {"dtype": "float32"},
}


def convergence_ab(paths: dict, exp_root: str, arms: dict, epochs: int = 2,
                   extra: dict | None = None) -> dict:
    """Train each arm for ``epochs`` epochs of the recipe with no dev eval
    and no cadence checkpoint (the same batches in the same order: the
    loader's seed stays 0 unless an arm sets ``seed``); returns {arm:
    [(step, loss, ctc_loss, ce_loss, TF accuracy)]} and prints them side
    by side."""
    curves = {}
    os.makedirs(exp_root, exist_ok=True)
    for arm, words in arms.items():
        cmd = soak.train_cmd({**paths, "dev": "", "test": ""}, exp_root, {
            "num_epoch": epochs, "save_every_iter": 0, "eval_every_iter": 0,
            "exp_name": f"ab_{arm}", **(extra or {}), **words})
        t0 = time.time()
        soak.run_to_completion(cmd, os.path.join(exp_root, f"ab_{arm}.log"))
        with open(os.path.join(exp_root, f"ab_{arm}", "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        curves[arm] = [(r["step"], r["train/loss"], r.get("train/ctc_loss"),
                        r.get("train/ce_loss"), soak._accuracy(r)) for r in rows]
        soak.log(f"ab {arm} ({words}): {time.time() - t0:.0f}s")
    for i, (step, *_) in enumerate(curves[next(iter(curves))]):
        soak.log(f"ab step {step}: " + "; ".join(
            f"{arm} loss {c[i][1]:.3f} ctc {c[i][2]:.3f} ce {c[i][3]:.4f} acc {c[i][4]:.3f}"
            for arm, c in curves.items() if i < len(c)))
    return curves


def main() -> None:
    soak._require_cuda()
    arms = {a: AB_ARMS[a] for a in (sys.argv[1:] or AB_ARMS)}
    paths = soak.gen_corpus(os.path.join(soak.ROOT, f"corpus{soak.TRAIN_N}"))
    curves = convergence_ab(paths, os.path.join(soak.ROOT, "ab"), arms)
    with open(os.path.join(soak.ROOT, "ab.json"), "w") as f:
        json.dump(curves, f)


if __name__ == "__main__":
    main()
