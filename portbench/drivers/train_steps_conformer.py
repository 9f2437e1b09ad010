"""A closed loop of train steps of the rel-pos conformer (traffic
``driver: train_steps_conformer``): ``train_steps.py``'s loop, checks and
record over the configuration's own weights (``weights_conformer.py``) and
plain reference (``reference/conformer.py``), which runs each checked batch
in blocks of the mix's ``reference_rows`` rows, each with its rows'
dropout masks, so that it fits the card beside nothing. The record also
holds the launch counts of K11 and K12 (the rel-pos attention kernels) in
the traced steps, under ``kind`` "train_conformer".

Beside ``train_steps.compare``'s numbers the cell reads
``grad_direction_gap``: the median over the counted leaves of 1 - cos of
the angle between the program's first clipped gradient and the
reference's. This configuration's gradient norm at the seed's weights is
10^4-10^5 times the clip's 5, set by the frontend's first convolution,
whose gradient is a long sum that cancels; its bf16 round-off moves the
clip's scale, every leaf's norm with it, and the worst leaf's norm as far
as half a batch moves it. A direction is the batch's own signal, which
the scale leaves alone."""

from __future__ import annotations

import math
import time

import torch

import statistics

from .. import checks, generate, port
from ..common import free_cuda, log, peak_bytes, spread_line, sync
from ..reference.conformer import ConformerTrainer
from ..reference.precision import Precision, no_tf32
from ..trace import traced
from ..weights_conformer import make_weights
from . import train_steps
from .train_steps import KEYS, _shape, step_record


def launches() -> dict:
    """The port's launch counters, K11 and K12 with them where the program
    has them."""
    from asr_chinese_e2e_tpu_torch.ops import fused_attention

    out = port.launches()
    for name, fn in (("K11", "relpos_attention_kernel"),
                     ("K12", "relpos_attention_backward_kernel")):
        counter = getattr(getattr(fused_attention, fn, None), "launches", None)
        if counter is not None:
            out[name] = int(counter)
    return out


def weights(ctx) -> dict:
    return make_weights(ctx.config["model"], ctx.config["vocab_size"], ctx.seed, ctx.device)


def program_readings(ctx, state, train_step, pool, feed) -> dict:
    """The checked steps through the program: losses, each utterance's loss
    from the first step's forward, first gradient and change per leaf."""
    names = port.parameter_names(state)
    b1 = float(ctx.config["train"]["adam_b1"])
    out = {"loss": []}
    for i in range(int(ctx.mix["checked_steps"])):
        args = feed(pool[i])
        if i == 0:
            with port.forward_outputs(state.model) as seen:
                state, metrics = train_step(state, *args, ctx.seed)
            out["rows"] = port.utterance_losses(ctx.config, seen[0], args[2], args[3])
            del seen
            moments = port.first_moments(state, names)
            out["grad"] = {n: float(m.norm()) / (1.0 - b1) for n, m in moments.items()}
            out["grad_vec"] = {n: m.detach().float().cpu() / (1.0 - b1)
                               for n, m in moments.items()}
        else:
            state, metrics = train_step(state, *args, ctx.seed)
        out["loss"].append(float(metrics["loss"]))
    w0 = weights(ctx)
    out["change"] = {n: float((p.detach() - w0[n]).norm())
                     for n, p in state.model.named_parameters()}
    return out


def reference_readings(ctx, pool, prec: Precision) -> dict:
    """The checked steps through the plain reference, in row blocks."""
    dev = ctx.device
    w0 = weights(ctx)
    ref = ConformerTrainer(ctx.config["model"], w0, ctx.config["train"],
                           ctx.config["features"], prec, int(ctx.mix["reference_rows"]))
    out = {"loss": []}
    for i in range(int(ctx.mix["checked_steps"])):
        batch = {k: torch.from_numpy(pool[i][k]).to(dev) for k in KEYS}
        for k in ("wave_lengths", "labels", "label_lengths"):
            batch[k] = batch[k].long()
        step = ref.step(batch, ctx.seed)
        out["loss"].append(step["loss"])
        if i == 0:
            out["rows"] = step["rows"]
            out["grad"] = {n: float(g.norm()) for n, g in step["grads"].items()}
            out["grad_vec"] = {n: g.detach().float().cpu() for n, g in step["grads"].items()}
    out["change"] = {n: float((p.detach() - w0[n]).norm()) for n, p in ref.params.items()}
    return out


def direction_gap(program: dict, reference: dict, counted) -> float:
    """The median over the ``counted`` leaves of 1 - cos(program's first
    gradient, reference's): the gradient's direction, which the clip's
    scale leaves alone; infinite where a gradient is not finite."""
    gaps = []
    for n in counted:
        p, r = program[n].double().flatten(), reference[n].double().flatten()
        if not (torch.isfinite(p).all() and torch.isfinite(r).all()):
            return math.inf
        gaps.append(1.0 - float(p @ r) / max(float(p.norm() * r.norm()), 1e-300))
    return statistics.median(gaps)


def compare(prog: dict, ref: dict, min_grad_share: float) -> tuple:
    """``train_steps.compare``'s (numbers, details) and
    ``grad_direction_gap`` over the counted leaves."""
    numbers, details = train_steps.compare(prog, ref, min_grad_share)
    counted = sorted(set(ref["grad"]) - set(details["left_out"]))
    numbers["grad_direction_gap"] = direction_gap(prog["grad_vec"], ref["grad_vec"], counted)
    return numbers, details


def run(ctx) -> dict:
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    if "host_threads" in mix and dev.type == "cuda":
        # the mix's intra-op threads, as torchrun sets them for a worker
        torch.set_num_threads(int(mix["host_threads"]))
    state, train_step = port.build_train_step(config, weights(ctx), dev)
    pool = generate.train_pool(mix, ctx.seed, dev)

    def feed(batch):
        return [torch.from_numpy(batch[k]).to(dev, non_blocking=True) for k in KEYS]

    n_checked = int(mix["checked_steps"])
    prog = program_readings(ctx, state, train_step, pool, feed)
    seen = {_shape(b) for b in pool[:n_checked]}
    for batch in pool[n_checked:]:
        if _shape(batch) not in seen:
            seen.add(_shape(batch))
            train_step(state, *feed(batch), ctx.seed)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    steps, i, host_s = [], n_checked, []
    t0 = now = time.perf_counter()
    while now - t0 < ctx.seconds:
        batch = pool[i % len(pool)]
        _, metrics = train_step(state, *feed(batch), ctx.seed)
        steps.append(step_record(batch))
        i += 1
        host_s.append(time.perf_counter() - now)
        now = time.perf_counter()
    sync(dev)
    window_s = time.perf_counter() - t0
    log(spread_line("host time a step", host_s))
    last_loss = float(metrics["loss"])

    record = {"kind": "train_conformer", "config": config, "mix": mix, "window_s": window_s,
              "steps": steps, "trace": None, "traced_steps": [], "traced_launches": {}}
    if ctx.trace and dev.type == "cuda":
        batches = [pool[(i + j) % len(pool)] for j in range(int(mix["trace_steps"]))]
        before = launches()

        def segment():
            for b in batches:
                train_step(state, *feed(b), ctx.seed)

        record["trace"] = traced(segment)
        after = launches()
        record["traced_launches"] = {k: after[k] - before[k] for k in after}
        record["traced_steps"] = [step_record(b) for b in batches]
    record["memory_peak_bytes"] = peak_bytes(dev)
    audio = sum(s["audio_s"] for s in steps)
    record["e2e"] = {"train_audio_s_per_s": audio / window_s, "setup_s": setup_s}
    record["attempted"] = len(steps)
    record["failed"] = 0 if math.isfinite(last_loss) else len(steps)

    del state, train_step, metrics
    free_cuda(dev)
    no_tf32()
    ref = reference_readings(ctx, pool, Precision("f32"))
    numbers, details = compare(prog, ref, float(mix["min_grad_share"]))
    log(f"train check: {details}")
    record["correct"], record["checks"] = checks.judge(numbers, ctx.limits)
    if not math.isfinite(last_loss):
        record["correct"] = False
    return record
