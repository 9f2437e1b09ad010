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
