"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own sizes (not part of a benchmark run):

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control 21,22,23] [--fault 31,32,33] [--seconds 12]

- ``--seeds``: sound runs of the program. A training cell's readings need
  no window: set-up's checked steps against the reference. A decode cell
  runs the driver with a short window of ``--seconds`` at the cell's load,
  long enough to answer the requests that a run judges.
- ``--control``: the plain reference put in the program's place with its
  products' operands rounded to float8 e4m3 (``reference/precision.py``),
  judged as the program is.
- ``--fault`` (training cells): the program's checked steps on half of
  each batch, the mean taken over that half.

Prints one JSON line per reading, then the largest program reading and the
smallest control and fault readings of each number."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _ctx(args, seed, workdir):
    import torch

    from portbench.run import Context, load_json

    return Context(load_json(ROOT, "BENCHMARK.json"), args.workload, seed, args.seconds,
                   False, torch.device("cuda", 0), workdir)


def train_readings(ctx, kind: str) -> dict:
    from portbench import generate, port
    from portbench.common import free_cuda
    from portbench.drivers import train_steps as ts
    from portbench.reference.precision import Precision, no_tf32

    import torch

    pool = generate.train_pool(ctx.mix, ctx.seed, ctx.device)[: int(ctx.mix["checked_steps"])]
    half = kind == "fault"
    if kind == "control":
        no_tf32()
        got = ts.reference_readings(ctx, pool, Precision("fp8"))
    else:
        from portbench.weights import make_weights

        w = make_weights(ctx.config["model"], ctx.config["vocab_size"], ctx.seed, ctx.device)
        state, step = port.build_train_step(ctx.config, w, ctx.device)
        del w

        def feed(batch):
            rows = batch["wave"].shape[0] // 2 if half else None
            return [torch.from_numpy(batch[k][:rows]).to(ctx.device) for k in ts.KEYS]

        got = ts.program_readings(ctx, state, step, pool, feed)
        del state, step
        free_cuda(ctx.device)
    no_tf32()
    ref = ts.reference_readings(ctx, pool, Precision("f32"))
    numbers, details = ts.compare(got, ref, float(ctx.mix["min_grad_share"]))
    return {"numbers": numbers, "details": details}


def decode_readings(ctx, kind: str) -> dict:
    from portbench import generate
    from portbench.drivers import recognize_calls as rc
    from portbench.reference.precision import Precision, no_tf32

    if kind == "program":
        record = rc.run(ctx)
        return {"numbers": {k: v["value"] for k, v in record["checks"].items()},
                "requests": record["attempted"]}
    clips = generate.clips(ctx.mix, ctx.seed, ctx.device)
    import numpy as np

    rng = np.random.default_rng(ctx.seed + 7)
    pick = sorted(set(rng.choice(len(clips), int(ctx.mix["check_sample"]) - 1,
                                 replace=False).tolist())
                  | {int(np.argmax([len(c) for c in clips]))})
    no_tf32()
    items = rc.control_items(ctx, [clips[i] for i in pick], Precision("fp8"))
    numbers, details = rc.judge_decode(ctx, items, Precision("f32"))
    return {"numbers": numbers, "details": details}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    seeds = {kind: [int(s) for s in getattr(args, name).split(",") if s]
             for kind, name in (("program", "seeds"), ("control", "control"),
                                ("fault", "fault"))}
    summary = {}
    for kind, group in seeds.items():
        for seed in group:
            workdir = tempfile.mkdtemp(prefix="portbench_cal_")
            t0 = time.perf_counter()
            try:
                ctx = _ctx(args, seed, workdir)
                read = (train_readings if ctx.mix["driver"] == "train_steps"
                        else decode_readings)(ctx, kind)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            read.update(kind=kind, seed=seed, seconds=time.perf_counter() - t0)
            print(json.dumps(read, default=str), flush=True)
            for name, value in read["numbers"].items():
                summary.setdefault(kind, {}).setdefault(name, []).append(value)
    out = {}
    for kind, numbers in summary.items():
        pick = max if kind == "program" else min
        out[kind] = {name: pick(vals) for name, vals in numbers.items()}
    print(json.dumps({"summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
