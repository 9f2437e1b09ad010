"""Run one benchmark cell on this machine's card and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` at the checkout's root; its
configuration (``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``), the mix's driver
(``portbench/drivers/<driver>.py``), its limits
(``portbench/limits/<cell>.json``) and, with ``--trace 1``, its per-layer
metrics (``portbench/metrics/<metric>.py``) are found by name. The driver
builds the program and the inputs from the seed, warms up, measures for
``--seconds``, traces with ``--trace 1``, then holds what the timed path
produced to the plain reference. The last line of standard output is the
result; the compared numbers with their limits close standard error and
the result's ``checks`` key.

Exits non-zero, printing no result, without CUDA, with fewer cards than the
cell asks for, without the program beside the benchmark, or when a JAX
package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.common import log  # noqa: E402

PROGRAM = "asr_chinese_e2e_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "asr_chinese_e2e_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name is a JAX package's."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_by_path(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What a driver gets: the cell, its configuration, mix and limits, the
    run's options, the device and a scratch directory."""

    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool,
                 device, workdir: str):
        self.bench = bench
        self.cell = next(w for w in bench["workloads"] if w["name"] == cell)
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = load_json(ROOT, conf["file"])
        self.mix = load_json(HERE, "traffic", self.cell["traffic"] + ".json")
        limits = os.path.join(HERE, "limits", cell + ".json")
        self.limits = load_json(limits)["limits"] if os.path.exists(limits) else {}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.workdir = device, workdir
        self.t_start = T_START


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def e2e_quantity(name: str) -> str:
    """The quantity a driver reports for the end-to-end metric ``name``: the
    name up to its first dot. A suffix gives one quantity a metric of its own
    in a group of cells, each with its own bound."""
    return name.split(".", 1)[0]


def device_info(record: dict, trace: bool, kind: str) -> dict:
    out = {"platform": "gpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if trace and record.get("trace") is not None:
        out["busy_s"] = record["trace"].busy_s
        out["window_s"] = record["trace"].window_s
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def result_line(bench: dict, cell: str, record: dict, trace: bool, kind: str) -> dict:
    """The result: the cell's end-to-end metrics (``trace`` off) or its
    per-layer metrics as its readers find them (``trace`` on), the device
    ``kind`` and peak, the breakdown, and the compared numbers last."""
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if not applies(m, cell):
                continue
            reader = load_by_path(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                  "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.value(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, cell):
                metrics[m["name"]] = {"value": record["e2e"][e2e_quantity(m["name"])],
                                      "unit": m["unit"]}
    out = {"correct": record["correct"], "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics,
           "device": device_info(record, trace, kind)}
    if trace and record.get("trace") is not None:
        out["breakdown"] = record["trace"].breakdown()
    out["checks"] = record["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_path):
        log(f"no BENCHMARK.json at {ROOT}")
        return 2
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
        return 2
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        log(f"the program {PROGRAM} is not beside the benchmark at {ROOT}")
        return 2
    # the port's kernels build into build/kernels/ of this checkout; any
    # other compiler cache a library keeps goes there too
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    if not torch.cuda.is_available():
        log("CUDA is not available: this benchmark measures the card and has no CPU fallback")
        return 2
    chips = int(cells[args.workload]["chips"])
    if torch.cuda.device_count() < chips:
        log(f"the cell asks for {chips} card(s); this machine has {torch.cuda.device_count()}")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    ctx_mix = load_json(HERE, "traffic", cells[args.workload]["traffic"] + ".json")
    driver = importlib.import_module(f"portbench.drivers.{ctx_mix['driver']}")
    workdir = tempfile.mkdtemp(prefix="portbench_")
    try:
        ctx = Context(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), workdir)
        with contextlib.redirect_stdout(sys.stderr):
            record = driver.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        log(f"a JAX package was loaded in this run: {', '.join(found)}")
        return 3
    line = result_line(bench, args.workload, record, bool(args.trace),
                       torch.cuda.get_device_name(0))
    for name, c in record["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
