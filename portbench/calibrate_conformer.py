"""Readings that the limits of ``correct`` of the rel-pos conformer's cell
are set from, on the card (not part of a benchmark run); ``calibrate.py``'s
training readings through the conformer's driver
(``drivers/train_steps_conformer.py``):

    python3 portbench/calibrate_conformer.py [--workload <cell>] --seeds 11,12,... \\
        [--control 21,22] [--fault 31,32] [--loss-fault 41,42]

``--seeds``: sound runs (set-up's checked steps against the reference);
``--control``: the reference with its products' operands in float8 e4m3
in the program's place; ``--fault``: the program's checked steps on half
of each batch; ``--loss-fault``: the forward over the whole batch and the
loss over its first half. Prints one JSON line per reading, then the
largest sound reading and the smallest control and fault readings of each
number."""

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
CELL = "train.espnet-conformer.aishell-fill"


def readings(ctx, kind: str) -> dict:
    import torch

    from portbench import generate
    from portbench.calibrate import loss_over_half
    from portbench.common import free_cuda
    from portbench.drivers import train_steps as ts
    from portbench.drivers import train_steps_conformer as tc
    from portbench import port
    from portbench.reference.precision import Precision, no_tf32

    pool = generate.train_pool(ctx.mix, ctx.seed, ctx.device)[: int(ctx.mix["checked_steps"])]
    half = kind == "fault"
    if kind == "control":
        no_tf32()
        got = tc.reference_readings(ctx, pool, Precision("fp8"))
    else:
        state, step = port.build_train_step(ctx.config, tc.weights(ctx), ctx.device)

        def feed(batch):
            rows = batch["wave"].shape[0] // 2 if half else None
            return [torch.from_numpy(batch[k][:rows]).to(ctx.device) for k in ts.KEYS]

        with loss_over_half(kind == "loss_fault"):
            got = tc.program_readings(ctx, state, step, pool, feed)
        del state, step
        free_cuda(ctx.device)
    no_tf32()
    ref = tc.reference_readings(ctx, pool, Precision("f32"))
    free_cuda(ctx.device)
    numbers, details = tc.compare(got, ref, float(ctx.mix["min_grad_share"]))
    return {"numbers": numbers, "details": details}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--loss-fault", default="")
    args = ap.parse_args()
    args.seconds = 0.0
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench.calibrate import _ctx

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    seeds = {kind: [int(s) for s in getattr(args, name).split(",") if s]
             for kind, name in (("program", "seeds"), ("control", "control"),
                                ("fault", "fault"), ("loss_fault", "loss_fault"))}
    summary = {}
    for kind, group in seeds.items():
        for seed in group:
            workdir = tempfile.mkdtemp(prefix="portbench_cal_")
            t0 = time.perf_counter()
            try:
                read = readings(_ctx(args, seed, workdir), kind)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            read.update(kind=kind, seed=seed, seconds=time.perf_counter() - t0)
            print(json.dumps(read, default=str), flush=True)
            for name, value in read["numbers"].items():
                summary.setdefault(kind, {}).setdefault(name, []).append(value)
    out = {kind: {name: (max if kind == "program" else min)(vals)
                  for name, vals in numbers.items()} for kind, numbers in summary.items()}
    print(json.dumps({"summary": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
