"""The port's host syncs on the card, listed by site: one unit of work of
each benchmark cell (a train step, a ``recognize`` call over one batch of
the offline mix, one online request), built as ``portbench/`` builds it,
runs under ``torch.cuda.set_sync_debug_mode("warn")`` with the spans of
``utils/debug.py`` on (a CPU-only profiler). Every synchronizing call is
listed with the innermost frame of the port that made it and the span
open around it: a site no ``sync.*`` span covers is "uncovered". Also
prints the span gate's cost with no profiler active (the cost every span
site adds to an untraced run) and the cost of a recorded span.

    python scripts/sync_sites_torch.py [--seed N] [--out chiprun_out/sync_sites.json]

Needs CUDA; prints one JSON document."""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from asr_chinese_e2e_tpu_torch.utils import debug  # noqa: E402

PORT = os.path.join(ROOT, "asr_chinese_e2e_tpu_torch") + os.sep
CELLS = {
    "train.ref-transformer.aishell-fill": ("ref-transformer", "aishell-train-fill"),
    "train.large-transformer.aishell": ("large-transformer", "aishell-train"),
    "offline.ref-transformer.beam-fill": ("ref-transformer", "offline-beam-fill"),
    "online.large-transformer.rescore": ("large-transformer", "online-rescore"),
}


def load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


class Watch:
    """Collects the synchronizing calls the sync debug mode reports."""

    def __init__(self):
        self.sites = collections.Counter()

    def show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        ours = [f for f in frames if f.filename.startswith(PORT)]
        where = (f"{os.path.relpath(ours[-1].filename, ROOT)}:{ours[-1].lineno}"
                 if ours else "outside the port")
        inner = frames[-1]
        stack = getattr(debug._OPEN, "stack", None) or []
        span = stack[-1].name if stack else None
        self.sites[(where, f"{os.path.basename(inner.filename)}:{inner.lineno}", span)] += 1

    def report(self) -> list:
        return [{"site": w, "innermost": i, "span": s, "count": n,
                 "covered": bool(s and s.startswith("sync."))}
                for (w, i, s), n in sorted(self.sites.items())]


def watched(unit):
    """Run ``unit()`` with spans on and the sync debug mode warning; returns
    (sites, {span name: count})."""
    from torch.profiler import ProfilerActivity, profile

    watch = Watch()
    torch.cuda.synchronize()
    debug.clear_spans()
    old = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = watch.show
        try:
            with profile(activities=[ProfilerActivity.CPU]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    unit()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        finally:
            warnings.showwarning = old
    torch.cuda.synchronize()
    names = collections.Counter(s.name for s in debug.spans())
    debug.clear_spans()
    return watch.report(), dict(sorted(names.items()))


def train_cell(config_name, mix_name, seed, dev):
    from portbench import generate, port
    from portbench.weights import make_weights

    config, mix = load("configs", config_name + ".json"), load("traffic", mix_name + ".json")
    weights = make_weights(config["model"], config["vocab_size"], seed, dev)
    state, step = port.build_train_step(config, weights, dev)
    mix = dict(mix, pool_batches=1) if "pool_batches" in mix else mix
    batch = generate.train_pool(mix, seed, dev)[0]
    keys = ("wave", "wave_lengths", "labels", "label_lengths")

    def unit():
        step(state, *[torch.from_numpy(batch[k]).to(dev, non_blocking=True) for k in keys],
             seed)

    unit()  # warm-up
    sites, names = watched(unit)
    return {"unit": "train step", "batch": list(batch["wave"].shape), "sites": sites,
            "spans": names}


def decode_cell(config_name, mix_name, seed, dev, workdir):
    from portbench import generate, port
    from portbench.drivers import recognize_calls as rc
    from portbench.weights import make_weights

    config, mix = load("configs", config_name + ".json"), load("traffic", mix_name + ".json")
    weights = make_weights(config["model"], config["vocab_size"], seed, dev)
    exp, vocab = port.write_experiment(config, weights, workdir)
    corpus = mix["request"] == "corpus"
    # one full batch of the offline mix; one clip online
    mix = dict(mix, clips=int(mix["recognize"]["batch_size"]) if corpus else 4)
    clips = generate.clips(mix, seed, dev)
    if corpus:  # the clips of one padded length, so that they make one batch
        clips = [c if len(c) <= 4 * 16000 else c[: 4 * 16000] for c in clips]
        clips = [c for c in clips if len(c) > 2 * 16000]
        clips = (clips * mix["recognize"]["batch_size"])[: mix["recognize"]["batch_size"]]
    paths = rc.write_clips(workdir, clips)
    client = rc.Client(exp, vocab, mix["recognize"], dev)
    what = ({"manifest": rc.write_manifest(os.path.join(workdir, "m.jsonl"), paths, clips)}
            if corpus else {"wav": paths[0]})
    client.call(keep=False, **what)  # warm-up and the experiment's load
    out = {}

    def unit():
        out["call"] = client.call(keep=False, **what)

    sites, names = watched(unit)
    rc._drop_program_model()
    return {"unit": "recognize call", "batches": out["call"]["timing"]["batches"],
            "sites": sites, "spans": names}


def gate_cost(n: int = 1_000_000) -> dict:
    """ns a span site costs with no profiler active, and a recorded span's
    cost under a CPU profiler, on the host's clock."""
    from torch.profiler import ProfilerActivity, profile

    annotate = debug.annotate
    out = {}
    for rep in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            pass
        t1 = time.perf_counter_ns()
        for _ in range(n):
            with annotate("gate"):
                pass
        t2 = time.perf_counter_ns()
        out[f"off_ns_{rep}"] = ((t2 - t1) - (t1 - t0)) / n
    m = 20_000
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        for _ in range(m):
            with annotate("gate"):
                pass
        t1 = time.perf_counter_ns()
    debug.clear_spans()
    out["on_ns"] = (t1 - t0) / m
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sync_sites.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("CUDA is not available: the sync debug mode watches the card", file=sys.stderr)
        return 2
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    dev = torch.device("cuda", 0)
    result = {"card": torch.cuda.get_device_name(0), "gate": gate_cost(), "cells": {}}
    for cell, (config, mix) in CELLS.items():
        t0 = time.perf_counter()
        if cell.startswith("train"):
            result["cells"][cell] = train_cell(config, mix, args.seed, dev)
        else:
            with tempfile.TemporaryDirectory() as wd:
                result["cells"][cell] = decode_cell(config, mix, args.seed, dev, wd)
        result["cells"][cell]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
