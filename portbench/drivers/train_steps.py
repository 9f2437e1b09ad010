"""A closed loop of train steps (traffic ``driver: train_steps``).

Set-up makes the weights and the mix's pool of batches from the seed,
builds the port's model, optimizer and ``train_step``
(``train/train_step.py::make_step_fns``), and drives that one state through
its first ``checked_steps`` steps on pool batches whose rows all differ,
through the window's own call and feed, keeping each step's loss, each
utterance's loss in the first step (its forward's output, as the step made
it, through the port's losses), the first step's clipped gradient per leaf
(read back from Adam's first moment) and each leaf's change after the last
checked step. It then takes one step of every other batch shape of the
pool, so that the window meets no new shape.

The window hands each pool batch to the card as ``Trainer.train_epoch``
does (host int16 waves, ``.to(device, non_blocking=True)``) and calls
``train_step`` until ``--seconds`` have passed, then waits for the card.
``train_audio_s_per_s`` is the unpadded audio of every step issued over the
window's wall time. With ``--trace 1`` the next ``trace_steps`` steps run
under the profiler. A mix's ``host_threads`` sets the process's intra-op
threads for a run on the card.

After the window the program's state is freed and the plain reference
(``reference/train.py``) follows the checked steps from the same weights
and batches: each step's loss, each utterance's first-step loss, each
leaf's first gradient and each leaf's change are compared
(``checks.leaf_gap``)."""

from __future__ import annotations

import math
import statistics
import time

import torch

from .. import checks, generate, port
from ..common import free_cuda, log, peak_bytes, spread_line, sync
from ..reference.precision import Precision, no_tf32
from ..reference.train import Trainer
from ..trace import traced
from ..weights import make_weights

KEYS = ("wave", "wave_lengths", "labels", "label_lengths")


def _shape(batch) -> tuple:
    return batch["wave"].shape, batch["labels"].shape


def step_record(batch) -> dict:
    b, s = batch["wave"].shape
    return {"batch": b, "n_samples": s, "label_len": batch["labels"].shape[1],
            "audio_s": batch["audio_s"]}


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
            out["grad"] = {n: float(m.norm()) / (1.0 - b1)
                           for n, m in port.first_moments(state, names).items()}
        else:
            state, metrics = train_step(state, *args, ctx.seed)
        out["loss"].append(float(metrics["loss"]))
    w0 = make_weights(ctx.config["model"], ctx.config["vocab_size"], ctx.seed, ctx.device)
    out["change"] = {n: float((p.detach() - w0[n]).norm())
                     for n, p in state.model.named_parameters()}
    return out


def reference_readings(ctx, pool, prec: Precision) -> dict:
    """The checked steps through the plain reference."""
    dev = ctx.device
    w0 = make_weights(ctx.config["model"], ctx.config["vocab_size"], ctx.seed, dev)
    ref = Trainer(ctx.config["model"], w0, ctx.config["train"], ctx.config["features"], prec)
    out = {"loss": []}
    for i in range(int(ctx.mix["checked_steps"])):
        batch = {k: torch.from_numpy(pool[i][k]).to(dev) for k in KEYS}
        batch["wave_lengths"] = batch["wave_lengths"].long()
        batch["label_lengths"] = batch["label_lengths"].long()
        batch["labels"] = batch["labels"].long()
        step = ref.step(batch, ctx.seed)
        out["loss"].append(step["loss"])
        if i == 0:
            out["rows"] = step["rows"]
            out["grad"] = {n: float(g.norm()) for n, g in step["grads"].items()}
    out["change"] = {n: float((p.detach() - w0[n]).norm()) for n, p in ref.params.items()}
    return out


def utterance_gaps(prog_rows: list, ref_rows: list) -> tuple:
    """(level, spread) of the first checked batch's utterances' relative
    loss gaps: the median over the utterances of each one's |gap|, and of
    each one's distance from the median gap. Both infinite where the
    program gave a loss for fewer utterances than the batch holds, or any
    loss on either side is not finite."""
    if len(prog_rows) != len(ref_rows) or not all(map(math.isfinite, prog_rows + ref_rows)):
        return math.inf, math.inf
    gaps = [(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_rows, ref_rows)]
    shared = statistics.median(gaps)
    return (statistics.median(abs(g) for g in gaps),
            statistics.median(abs(g - shared) for g in gaps))


def compare(prog: dict, ref: dict, min_grad_share: float) -> tuple:
    """(numbers, details): the worst step's relative loss gap, the first
    step's, the first step's utterances' median gap and their scatter
    around it (``utterance_gaps``), the worst leaf's first-gradient gap and
    the worst counted leaf's change gap. Leaves whose reference gradient is under ``min_grad_share`` of the
    median leaf's move by round-off alone and are not counted in the
    change."""
    gaps = [checks.relative_gap(p, r) for p, r in zip(prog["loss"], ref["loss"])]
    loss_gap = max(gaps)
    g_leaf, g_gap = checks.leaf_gap(prog["grad"], ref["grad"])
    grads = sorted(ref["grad"].values())
    floor = min_grad_share * grads[len(grads) // 2]
    counted = [n for n, g in ref["grad"].items() if g >= floor]
    c_leaf, c_gap = checks.leaf_gap(prog["change"], ref["change"], counted)
    utt_gap, utt_spread = utterance_gaps(prog["rows"], ref["rows"])
    numbers = {"loss_gap": loss_gap, "first_loss_gap": gaps[0], "utt_loss_gap": utt_gap,
               "utt_loss_spread": utt_spread, "grad_gap": g_gap, "change_gap": c_gap}
    details = {"grad_leaf": g_leaf, "change_leaf": c_leaf,
               "left_out": sorted(set(ref["grad"]) - set(counted)),
               "program_loss": prog["loss"], "reference_loss": ref["loss"]}
    return numbers, details


def run(ctx) -> dict:
    dev = ctx.device
    config, mix = ctx.config, ctx.mix
    if "host_threads" in mix and dev.type == "cuda":
        # the mix's intra-op threads, as torchrun sets them for a worker
        torch.set_num_threads(int(mix["host_threads"]))
    weights = make_weights(config["model"], config["vocab_size"], ctx.seed, dev)
    state, train_step = port.build_train_step(config, weights, dev)
    del weights
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

    record = {"kind": "train", "config": config, "mix": mix, "window_s": window_s,
              "steps": steps, "trace": None, "traced_steps": [], "traced_launches": {}}
    if ctx.trace and dev.type == "cuda":
        batches = [pool[(i + j) % len(pool)] for j in range(int(mix["trace_steps"]))]
        before = port.launches()

        def segment():
            for b in batches:
                train_step(state, *feed(b), ctx.seed)

        record["trace"] = traced(segment)
        after = port.launches()
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

