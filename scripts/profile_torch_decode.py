#!/usr/bin/env python
"""Where a beam decode step of the port goes, on one H100 unless the caller
asks for the CPU (the port of ``scripts/profile_decode.py`` and
``scripts/trace_decode.py``), on ``scripts/bench_decode_torch.py``'s batch:
the flagship (bf16, fused attention, fbank kernel), 64 x 8 s, beam 10,
max_len 40, random weights from seed 0.

1. **Components** of one step at B*K = 640 rows, each timed alone (``n``
   calls, host clock, ``torch.cuda.synchronize`` at the end), in ms:
   ``init_decode_state`` (the cross K/V), ``decode_step_lazy`` and
   ``decode_step`` (6 layers), the top-k over (64, K*V) with the searches'
   stable descending sort (``decode/beam.py::_top_k_stable``: equal scores
   in index order, as JAX's ``top_k``), the bookkeeping gathers (the
   physical self-cache gather of ``lazy=False``, and the ancestry map,
   tokens, finished flags and lengths of ``lazy=True``), and one
   cross-attention (``MultiHeadAttention.step_cross`` of layer 0, the
   beam folded into the query).
2. **Trace**: one steady-state search of the batch (``--mode lazy | gather
   | joint``) under ``utils/debug.py::profile_trace`` (its 32 warm-up
   launches of a one-element add stay in the trace, before the search):
   wall and device ms, the device's busy share, the decode steps, and the
   kernels and the operators with the most device time, with their counts
   per search and per step. The Chrome trace goes to ``--trace_dir``.

    python3 scripts/profile_torch_decode.py [--mode lazy|gather|joint] [--n 20] [--top 25]
    python3 scripts/profile_torch_decode.py --device cpu --d_model 16 ...   # tiny, plain

On the CPU there is no device time: the trace lists host operators by
their own CPU time.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_decode_torch import (  # noqa: E402
    REPO,
    encoded_batch,
    searches,
    serving_config,
    serving_model,
)

from asr_chinese_e2e_tpu_torch.bench import card_of, resolve_device, sync  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.beam import (  # noqa: E402
    _top_k_stable,
    init_decode_state,
    make_gather_carry,
)
from asr_chinese_e2e_tpu_torch.utils.debug import profile_trace  # noqa: E402


def _timeit(fn, dev, n: int, name: str, rows: dict):
    """ms per call of ``fn`` over ``n`` calls after one; returns its output."""
    out = fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    sync(dev)
    rows[name] = (time.perf_counter() - t0) / n * 1e3
    print(f"{name:52s} {rows[name]:9.3f} ms", flush=True)
    return out


@torch.inference_mode()
def components(model, enc_out, enc_lens, beam: int, max_len: int, n: int = 20) -> dict:
    """ms of each component of one beam step at B*K rows (see the module
    docstring)."""
    dev = enc_out.device
    bsz = enc_out.shape[0]
    bk = bsz * beam
    rows = {}
    state = _timeit(lambda: init_decode_state(model, enc_out, enc_lens, max_len + 1, beam),
                    dev, n, "init_decode_state (cross k/v)", rows)
    tokens = torch.full((bk,), 2, dtype=torch.int64, device=dev)
    anc = torch.zeros((bsz, beam, max_len + 1), dtype=torch.int64, device=dev)
    layers = model.cfg.num_decoder_layers
    logp, _ = _timeit(lambda: model.decode_step_lazy(tokens, state, 5, anc), dev, n,
                      f"decode_step_lazy ({layers}L, B*K={bk})", rows)
    _timeit(lambda: model.decode_step(tokens, state, 5), dev, n,
            f"decode_step ({layers}L, B*K={bk})", rows)
    v = logp.shape[-1]
    scores = torch.zeros((bsz, beam), dtype=torch.float32, device=dev)
    cand = (scores[:, :, None] + logp.reshape(bsz, beam, v)).reshape(bsz, beam * v)
    _, top_idx = _timeit(lambda: _top_k_stable(cand, beam), dev, n,
                         f"stable top-k ({bsz}, {beam * v})", rows)
    parent = top_idx // v
    gather_carry = make_gather_carry(bsz, beam)
    _timeit(lambda: gather_carry(state["carry"], parent), dev, n,
            f"physical self-cache gather (B*K={bk})", rows)
    toks = torch.zeros((bsz, beam, max_len + 1), dtype=torch.int64, device=dev)
    finished = torch.zeros((bsz, beam), dtype=torch.bool, device=dev)
    lengths = torch.zeros((bsz, beam), dtype=torch.int64, device=dev)

    def lazy_bookkeeping():
        idx = parent[:, :, None].expand(-1, -1, max_len + 1)
        return (anc.gather(1, idx), toks.gather(1, idx), finished.gather(1, parent),
                lengths.gather(1, parent))

    _timeit(lazy_bookkeeping, dev, n, "lazy bookkeeping gathers (anc, tokens, flags)", rows)
    layer = model.decoder.layers[0]
    x = torch.zeros((bk, 1, model.cfg.d_model), dtype=model.compute_dtype, device=dev)
    static = state["static"]
    _timeit(lambda: layer.cross_attn.step_cross(x, static["cross"][0], static["cross_bias"]),
            dev, n, f"one cross-attention ({bk}, {enc_out.shape[1]})", rows)
    return rows


def _self_us(e, device: bool) -> float:
    if not device:
        return e.self_cpu_time_total
    # called self_cuda_time_total in older torch
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def trace(model, enc_out, enc_lens, beam: int, max_len: int, mode: str = "lazy",
          top: int = 25, trace_dir: str = os.path.join(REPO, "build", "profile_decode")) -> dict:
    """One warm search, then one under the profiler: wall and device ms,
    the busy share, the decode steps and the top kernels and operators."""
    dev = enc_out.device
    on_card = dev.type == "cuda"
    search = searches(model, enc_out, enc_lens, beam, max_len)[mode]
    search()
    sync(dev)
    steps = [0]
    method = "decode_step_lazy" if mode != "gather" else "decode_step"
    inner = getattr(model, method)

    def counted(*a, **kw):
        steps[0] += 1
        return inner(*a, **kw)

    setattr(model, method, counted)
    try:
        with profile_trace(trace_dir) as prof:
            t0 = time.perf_counter()
            search()
            sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        delattr(model, method)
    events = list(prof.key_averages())
    kernels = [e for e in events if e.device_type != DeviceType.CPU]
    ops = [e for e in events if e.device_type == DeviceType.CPU]
    device_ms = sum(_self_us(e, True) for e in kernels) / 1e3 if on_card else None
    n_steps = max(steps[0], 1)
    print(f"trace, {mode} search ({steps[0]} decode steps): wall {wall_ms:.3f} ms, " + (
        f"device {device_ms:.3f} ms, device busy {device_ms / wall_ms * 100:.1f} % of wall, "
        f"{sum(e.count for e in kernels) / n_steps:.1f} kernels a step" if on_card
        else "device not measured (no card)"), flush=True)
    out = {"mode": mode, "steps": steps[0], "wall_ms": wall_ms, "device_ms": device_ms,
           "busy": device_ms / wall_ms if on_card else None, "kernels": [], "ops": []}
    tables = (("kernels", kernels, True), ("ops", ops, on_card))
    for title, evs, device in tables:
        if not evs or (title == "kernels" and not on_card):
            continue
        evs = sorted((e for e in evs if _self_us(e, device) > 0),
                     key=lambda e: _self_us(e, device), reverse=True)
        total = sum(_self_us(e, device) for e in evs) / 1e3
        clock = "device" if device else "host"
        print(f"{clock + ' ms':>12} {'share':>6} {'count':>7} {'a step':>7}  {title[:-1]}")
        for e in evs[:top]:
            ms = _self_us(e, device) / 1e3
            print(f"{ms:12.3f} {ms / total * 100:5.1f}% {e.count:7d} {e.count / n_steps:7.1f}  "
                  f"{e.key[:100]}")
            out[title].append({"name": e.key, "ms": ms, "count": e.count})
    return out


def main(
    batch: int = 64,
    beam: int = 10,
    max_len: int = 40,
    vocab_size: int = 4233,
    seconds: float = 8.0,
    dtype: str = "bfloat16",
    mode: str = "lazy",
    n: int = 20,
    top: int = 25,
    do_trace: bool = True,
    trace_dir: str = os.path.join(REPO, "build", "profile_decode"),
    device: str = "cuda",
    **model_overrides,
) -> dict:
    dev = resolve_device(device)
    card = card_of(dev)
    print(f"card: {card}", flush=True)
    cfg, feat_cfg = serving_config(dtype, **model_overrides)
    model = serving_model(cfg, vocab_size, dev)
    enc_out, enc_lens = encoded_batch(model, feat_cfg, batch, seconds, dev)
    out = {"components": components(model, enc_out, enc_lens, beam, max_len, n)}
    if do_trace:
        out["trace"] = trace(model, enc_out, enc_lens, beam, max_len, mode, top, trace_dir)
    print(json.dumps({"bench": "profile_decode", "card": card, "batch": batch, "beam": beam,
                      "components_ms": out["components"], **({"trace": {
                          k: v for k, v in out["trace"].items() if k not in ("kernels", "ops")}}
                          if do_trace else {})}))
    return out


if __name__ == "__main__":
    from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    main(**kwargs)
