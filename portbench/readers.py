"""What the per-layer metric files (``metrics/<name>.py``) read from a run's
record. Each returns None where the record holds nothing to read, and the
harness then leaves the metric out of the result."""

from __future__ import annotations

from .common import decode_boundaries
from .counts import bounds, flops
from .counts.peaks import peak_flops

# kernel names of K1 + K2 and of K3 + K4 in the profiler's trace
ATTENTION_KERNELS = ("attention_fwd", "attention_bwd")
CTC_KERNELS = ("ctc_emission_rows", "ctc_alpha_recursion", "ctc_beta_recursion", "ctc_grad_rows")


def _calls(record, kind: str):
    return record.get("calls") if record.get("kind") == kind else None


def host_ms_per_batch(record) -> float | None:
    """``recognize``'s own host work a batch: call wall less its encode and
    search spans, over the batches."""
    calls = _calls(record, "decode")
    if not calls:
        return None
    rest = sum(c["wall_s"] - c["timing"]["encode_s"] - c["timing"]["search_s"] for c in calls)
    return rest / sum(c["timing"]["batches"] for c in calls) * 1e3


def span_ms_per_batch(record, span: str) -> float | None:
    """Mean seconds a batch of ``recognize``'s ``timing[span]``, in ms."""
    calls = _calls(record, "decode")
    if not calls:
        return None
    return sum(c["timing"][span] for c in calls) / sum(c["timing"]["batches"] for c in calls) * 1e3


def train_mfu(record) -> float | None:
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    cfg, feat = record["config"]["model"], record["config"]["features"]
    v = record["config"]["vocab_size"]
    total = sum(flops.analytic_train_flops(cfg, feat, v, s["batch"], s["n_samples"],
                                           s["label_len"]) for s in record["steps"])
    return 100.0 * total / record["window_s"] / peak_flops(cfg["dtype"])


def decode_batches(record, what: dict) -> list:
    """[(rows, padded samples, [clip indices])] of one ``recognize`` call, by
    its bucketing: clips grouped by padded length in request order, then
    cut into batches of ``batch_size`` rows."""
    mix = record["mix"]
    bsz = int(mix["recognize"]["batch_size"])
    bounds_ = decode_boundaries(mix)
    if "manifest" in what:
        idx = list(range(len(record["clip_samples"])))
    else:
        idx = [record["paths"].index(what["wav"])]
    groups = {}
    for i in idx:
        n = record["clip_samples"][i]
        groups.setdefault(next(b for b in bounds_ if n <= b), []).append(i)
    out = []
    for b in sorted(groups):
        for j in range(0, len(groups[b]), bsz):
            out.append((bsz, b, groups[b][j : j + bsz]))
    return out


def decode_call_flops(record, call) -> float:
    """Matmul FLOPs of one call's work: every batch's rows through the
    encoder at their padded length, then the search: the cached beam for
    ``max_decode_len`` steps, or the CTC head and the rescoring forward
    over ``beam_size`` hypotheses of the served length (the n-best's
    lengths are not returned)."""
    cfg, feat = record["config"]["model"], record["config"]["features"]
    v = record["config"]["vocab_size"]
    opts = record["mix"]["recognize"]
    total = 0.0
    for rows, n, _ in decode_batches(record, call["what"]):
        if opts["mode"] == "beam":
            per_row = (flops.encoder_flops(cfg, feat, n, False, v)
                       + flops.beam_flops(cfg, feat, n, v, int(opts["beam_size"]),
                                          int(opts["max_decode_len"])))
        else:
            per_row = (flops.encoder_flops(cfg, feat, n, True, v)
                       + flops.rescore_flops(cfg, feat, n, v, int(opts["beam_size"]),
                                             call.get("served_len", 0)))
        total += rows * per_row
    return total


def decode_mfu(record) -> float | None:
    calls = _calls(record, "decode")
    if not calls:
        return None
    total = sum(decode_call_flops(record, c) for c in calls)
    return 100.0 * total / record["window_s"] / peak_flops(record["config"]["model"]["dtype"])


def idle_share(record) -> float | None:
    trace = record.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * trace.idle_share()


def _train_traced(record):
    if record.get("kind") != "train" or record.get("trace") is None:
        return None
    return record["traced_steps"] or None


def attention_roofline(record) -> float | None:
    """The K1 + K2 launches of the traced steps: their least time (one
    forward and one backward per encoder layer a step, at the step's padded
    shapes) over their device time. None unless the launch counters saw
    exactly those launches."""
    steps = _train_traced(record)
    if steps is None:
        return None
    cfg, feat = record["config"]["model"], record["config"]["features"]
    layers = int(cfg["num_encoder_layers"])
    n = layers * len(steps)
    if record["traced_launches"].get("K1") != n or record["traced_launches"].get("K2") != n:
        return None
    h, d = cfg["num_heads"], cfg["head_dim"]
    least = 0.0
    for s in steps:
        t = flops.num_lfr_frames(feat, flops.num_frames(feat, s["n_samples"]))
        least += layers * (bounds.attention_fwd_bound(s["batch"], h, t, t, d)["bound_ms"]
                           + bounds.attention_bwd_bound(s["batch"], h, t, t, d)["bound_ms"])
    spent = record["trace"].device_time(ATTENTION_KERNELS) * 1e3
    return 100.0 * least / spent if spent > 0 else None


def ctc_roofline(record) -> float | None:
    """The same for K3 + K4: one of each a step, over the step's (B, T, V)
    bf16 logits and S = 2 L + 1 extended labels."""
    steps = _train_traced(record)
    if steps is None:
        return None
    n = len(steps)
    if record["traced_launches"].get("K3") != n or record["traced_launches"].get("K4") != n:
        return None
    feat, v = record["config"]["features"], record["config"]["vocab_size"]
    least = 0.0
    for s in steps:
        t = flops.num_lfr_frames(feat, flops.num_frames(feat, s["n_samples"]))
        sx = 2 * s["label_len"] + 1
        least += (bounds.ctc_alpha_bound(s["batch"], t, v, sx)["bound_ms"]
                  + bounds.ctc_beta_bound(s["batch"], t, v, sx)["bound_ms"])
    spent = record["trace"].device_time(CTC_KERNELS) * 1e3
    return 100.0 * least / spent if spent > 0 else None


def device_ms_per_unit(record) -> float | None:
    """The device's busy time in the traced stretch over its units of work:
    a train step, or a ``recognize`` batch (a request, at batch 1), in ms."""
    trace = record.get("trace")
    if trace is None:
        return None
    if record.get("kind") == "train":
        n = len(record.get("traced_steps") or [])
    else:
        n = sum(c["timing"]["batches"] for c in record.get("traced_calls") or [])
    return trace.busy_s / n * 1e3 if n else None
