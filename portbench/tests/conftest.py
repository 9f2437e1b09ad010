"""Shared fixtures of the benchmark's CPU tests: tiny widths of the cells'
configurations, their mixes cut to a few clips, and a driver context on
the CPU (the port's kernels run their plain versions there)."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(d_model=16, num_heads=2, head_dim=8, d_ff=32, num_encoder_layers=2,
            num_decoder_layers=1)
TINY_VOCAB = 60


def load(*parts):
    with open(os.path.join(ROOT, "portbench", *parts)) as f:
        return json.load(f)


class Ctx:
    """A driver context as ``run.Context`` makes it, built by hand."""

    def __init__(self, config, mix, limits, seed, workdir, seconds=0.5):
        self.config, self.mix, self.limits = config, mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, False
        self.device = torch.device("cpu")
        self.workdir = str(workdir)
        self.t_start = time.perf_counter()


def tiny_config(name: str, dtype: str = "bfloat16") -> dict:
    c = load("configs", name + ".json")
    c["model"].update(TINY, dtype=dtype)
    c["vocab_size"] = TINY_VOCAB
    c["features"]["fbank_impl"] = "xla"
    return c


def tiny_mix(name: str) -> dict:
    m = load("traffic", name + ".json")
    if m["driver"] == "train_steps":
        m.update(batch=4, pool_batches=6, label_ids=[4, TINY_VOCAB])
    elif m["request"] == "corpus":
        m.update(clips=12, check_sample=4)
        m["recognize"].update(batch_size=4, beam_size=3, max_decode_len=5)
    else:
        m.update(clips=6, check_sample=3)
    return m


def full_config(name: str) -> dict:
    """A cell's configuration at its own widths, the fbank's plain version."""
    c = load("configs", name + ".json")
    c["features"]["fbank_impl"] = "xla"
    return c


def few_clips(name: str, n: int) -> dict:
    """A decode mix at its own search settings over ``n`` clips, all judged."""
    m = load("traffic", name + ".json")
    m.update(clips=n, check_sample=n)
    m["recognize"]["batch_size"] = min(n, m["recognize"]["batch_size"])
    return m


def cell_limits(cell: str) -> dict:
    path = os.path.join(ROOT, "portbench", "limits", cell + ".json")
    return load("limits", cell + ".json")["limits"] if os.path.exists(path) else {}


SPAN_SEED = 2**31 + 11


def _traced(fn):
    """The program's spans of ``fn()`` under a CPU profiler."""
    from torch.profiler import ProfilerActivity, profile

    from asr_chinese_e2e_tpu_torch.utils import debug

    debug.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return debug.spans()


def _train_spans(cell, tmp):
    from portbench import generate, port
    from portbench.drivers.train_steps import KEYS
    from portbench.weights import make_weights

    config, mix = tiny_config(cell["config"]), tiny_mix(cell["traffic"])
    dev = torch.device("cpu")
    weights = make_weights(config["model"], config["vocab_size"], SPAN_SEED, dev)
    state, train_step = port.build_train_step(config, weights, dev)
    pool = generate.train_pool(mix, SPAN_SEED, dev)
    feed = lambda b: [torch.from_numpy(b[k]) for k in KEYS]
    train_step(state, *feed(pool[0]), SPAN_SEED)
    return _traced(lambda: [train_step(state, *feed(b), SPAN_SEED) for b in pool[1:3]])


def _decode_spans(cell, tmp):
    from portbench import generate, port
    from portbench.drivers import recognize_calls
    from portbench.weights import make_weights

    config, mix = tiny_config(cell["config"]), tiny_mix(cell["traffic"])
    dev = torch.device("cpu")
    weights = make_weights(config["model"], config["vocab_size"], SPAN_SEED, dev)
    exp, vocab = port.write_experiment(config, weights, str(tmp))
    clips = generate.clips(mix, SPAN_SEED, dev)
    paths = recognize_calls.write_clips(str(tmp), clips)
    client = recognize_calls.Client(exp, vocab, mix["recognize"], dev)
    if mix["request"] == "corpus":
        what = [{"manifest": recognize_calls.write_manifest(str(tmp / "m.jsonl"), paths, clips)}]
    else:
        what = [{"wav": p} for p in paths[:3]]
    client.call(keep=False, **what[0])
    try:
        return _traced(lambda: [client.call(keep=False, **w) for w in what])
    finally:
        recognize_calls._drop_program_model()


@pytest.fixture(scope="session")
def recorded_spans(tmp_path_factory):
    """{cell: the program's spans of its traced units}: a profiled train
    step of each training cell's configuration and profiled ``recognize``
    calls of each decode cell's, at tiny widths on the CPU."""
    from asr_chinese_e2e_tpu_torch.utils import debug

    out = {}
    for cell in load("..", "BENCHMARK.json")["workloads"]:
        tmp = tmp_path_factory.mktemp(cell["name"].replace(".", "_"))
        train = tiny_mix(cell["traffic"])["driver"] == "train_steps"
        out[cell["name"]] = (_train_spans if train else _decode_spans)(cell, tmp)
    debug.clear_spans()
    return out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def make_ctx(tmp_path):
    def make(config, mix, limits=None, seed=2**31 + 5, seconds=0.5):
        return Ctx(config, mix, limits or {}, seed, tmp_path, seconds)

    return make
