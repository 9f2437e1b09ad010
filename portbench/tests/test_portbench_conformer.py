"""The rel-pos conformer's cell (``train.espnet-conformer.aishell-fill``) on
the CPU at tiny widths: its driver end to end with every new per-layer
metric read, its FLOP count against a count by hand, its control and its
half-batch faults against the cell's limits, and the plain reference's
row-blocked step against its whole-batch step."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import TINY_VOCAB, Ctx, cell_limits, load
from portbench import checks, generate, port, readers_conformer, run, spans, trace
from portbench.counts import conformer
from portbench.drivers import train_steps, train_steps_conformer as tc
from portbench.reference.conformer import ConformerTrainer
from portbench.reference.precision import Precision

CELL = "train.espnet-conformer.aishell-fill"
BENCH = load("..", "BENCHMARK.json")
NEW = [m["name"] for m in BENCH["per_layer"] if m.get("workloads") == [CELL]]
# accepted metrics whose lists the cell was appended to
SHARED = [m["name"] for m in BENCH["per_layer"]
          if CELL in m.get("workloads", ()) and m["name"] not in NEW]


def tiny_conformer(dtype: str = "bfloat16") -> dict:
    c = load("configs", "espnet-conformer.json")
    c["model"].update(d_model=16, num_heads=2, head_dim=8, d_ff=32, num_encoder_layers=2,
                      num_decoder_layers=1, frontend_channels=8, dtype=dtype)
    c["vocab_size"] = TINY_VOCAB
    c["features"]["fbank_impl"] = "xla"
    return c


def tiny_mix(batch: int = 4) -> dict:
    m = load("traffic", "aishell-train-fill-conformer.json")
    m.update(batch=batch, pool_batches=6, label_ids=[4, TINY_VOCAB], batch_seconds=10 * batch,
             reference_rows=3)
    return m


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    ctx = Ctx(tiny_conformer(), tiny_mix(), {}, 2**31 + 3, tmp_path_factory.mktemp("c"), 0.5)
    ctx.t_start = time.perf_counter()
    return tc.run(ctx)


@pytest.fixture(scope="module")
def step_spans():
    """The program's spans of two tiny conformer train steps under a CPU
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    from asr_chinese_e2e_tpu_torch.utils import debug

    ctx = Ctx(tiny_conformer(), tiny_mix(), {}, 2**31 + 11, ".", 0.5)
    dev = torch.device("cpu")
    state, step = port.build_train_step(ctx.config, tc.weights(ctx), dev)
    pool = generate.train_pool(ctx.mix, ctx.seed, dev)
    feed = lambda b: [torch.from_numpy(b[k]) for k in train_steps.KEYS]
    step(state, *feed(pool[0]), ctx.seed)
    debug.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for b in pool[1:3]:
            step(state, *feed(b), ctx.seed)
    out = debug.spans()
    debug.clear_spans()
    return out


def test_the_benchmark_lists_the_cell_and_its_metrics():
    assert len(NEW) == 8
    assert SHARED == ["sync_wait_ms.train"]
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["moves"] == "train_audio_s_per_s" and m["workloads"] == [CELL]
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert CELL in e2e["train_audio_s_per_s"]["workloads"]


def test_the_driver_reports_its_end_to_end_metrics(record):
    assert record["e2e"]["train_audio_s_per_s"] > 0 and record["e2e"]["setup_s"] > 0
    assert record["attempted"] > 0 and record["failed"] == 0
    assert set(record["checks"]) == {"loss_gap", "first_loss_gap", "utt_loss_gap",
                                     "utt_loss_spread", "grad_gap", "change_gap",
                                     "grad_direction_gap"}
    assert record["correct"] is False  # no limits given here


def test_every_new_metric_reads_the_rehearsal(record, step_spans, monkeypatch):
    from asr_chinese_e2e_tpu_torch.utils import debug

    monkeypatch.setattr(debug, "spans", lambda: list(step_spans))
    rec = dict(record)
    layers = int(rec["config"]["model"]["num_encoder_layers"])
    rec["traced_steps"] = rec["steps"][:2]
    n = len(rec["traced_steps"])
    rec["traced_launches"] = {"K11": n * layers, "K12": n * layers, "K3": n, "K4": n}
    names = ["void (anonymous namespace)::attention_fwd_mma_kernel<64, false, true>(x)",
             "void (anonymous namespace)::attention_bwd_dq_mma_kernel<64, false, true>(x)",
             "void (anonymous namespace)::attention_bwd_dkdv_mma_kernel<64, false, true>(x)",
             "void (anonymous namespace)::ctc_alpha_recursion_kernel<float>(x)",
             "void (anonymous namespace)::ctc_beta_recursion_kernel<float>(x)"]
    rec["trace"] = trace.Trace(window_s=2.0, busy_s=0.5, device_s={n: 0.05 for n in names},
                               gaps={"none": 1.5})
    line = run.result_line(BENCH, CELL, rec, True, "cpu rehearsal")
    assert set(line["metrics"]) == set(NEW) | set(SHARED)
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["metrics"]["syncs_per_step.train_conformer"]["value"] == spans.syncs_per(
        rec, "train_step")
    assert line["metrics"]["sync_wait_ms.train"]["value"] == spans.sync_wait_ms(rec)


def test_the_roofline_reads_only_rel_pos_kernels_and_whole_counts(record):
    rec = dict(record)
    layers = int(rec["config"]["model"]["num_encoder_layers"])
    rec["traced_steps"] = rec["steps"][:2]
    n = len(rec["traced_steps"])
    k1 = "void (anonymous namespace)::attention_fwd_mma_kernel<64, false, false>(x)"
    rec["trace"] = trace.Trace(2.0, 0.5, {k1: 0.05}, {})
    rec["traced_launches"] = {"K11": n * layers, "K12": n * layers}
    assert readers_conformer.relpos_roofline(rec) is None  # K1 alone: no rel-pos time
    rec["traced_launches"] = {"K11": n * layers - 1, "K12": n * layers}
    assert readers_conformer.relpos_roofline(rec) is None
    rec["traced_launches"] = {"K3": n, "K4": n}
    assert readers_conformer.ctc_roofline(rec) is None  # K1 alone: no CTC time
    rec["trace"].device_s["ctc_alpha_recursion_kernel"] = 0.01
    assert readers_conformer.ctc_roofline(rec) > 0
    rec["traced_launches"] = {"K3": n, "K4": n + 1}
    assert readers_conformer.ctc_roofline(rec) is None
    rec["kind"] = "train"
    assert readers_conformer.train_mfu(rec) is None
    assert readers_conformer.ctc_roofline(rec) is None


def test_flop_count_equals_a_hand_count():
    cfg = dict(d_model=4, d_ff=8, frontend_channels=2, conv_kernel_size=3,
               num_encoder_layers=1, num_decoder_layers=1)
    feat = dict(n_mels=9, hop_length=160, win_length=400, n_fft=400, center=True)
    # 1440 samples: 10 frames; frontend (10 - 1) // 2 = 4, then 1 frame; mels 9 -> 4 -> 1
    t_f, t1, f1, t, f2, v, l = 10, 4, 4, 1, 1, 5, 3
    d, ff, c, k = 4, 8, 2, 3
    fbank = t_f * 400 * (2 * 201) * 2 + t_f * 201 * 9 * 2  # the DFT as two products, mel
    front = t1 * f1 * c * 9 * 2 + t * f2 * c * 9 * c * 2 + t * f2 * c * d * 2
    block = (4 * t * d * ff * 2 + 4 * t * d * d * 2 + t * (2 * t - 1) * d * 2
             + 2 * t * t * d * 2 + 2 * t * d * d * 2 + t * d * d * 2 + t * d * k * 2)
    dec = (4 * l * d * d * 2 + 2 * l * l * d * 2 + 2 * l * d * d * 2 + 2 * t * d * d * 2
           + 2 * l * t * d * 2 + 2 * l * d * ff * 2) + l * d * v * 2
    per_utt = fbank + front + block + t * d * v * 2 + dec
    want = 3.0 * (2 * per_utt + (2 * t - 1) * d * d * 2)
    assert conformer.analytic_train_flops(cfg, feat, v, 2, 1440, l - 1) == want


def test_the_bounds_count_bytes_and_products():
    fwd = conformer.relpos_fwd_bound(2, 3, 5, 8)
    assert fwd["bytes"] == 2.0 * (4 * 2 * 3 * 5 * 8 + 2 * 3 * 5 * 5)
    assert fwd["flops"] == 4.0 * 2 * 3 * 5 * 5 * 8
    bwd = conformer.relpos_bwd_bound(2, 3, 5, 8)
    assert bwd["bytes"] == 2.0 * (8 * 2 * 3 * 5 * 8 + 2 * 2 * 3 * 5 * 5)
    assert bwd["flops"] == 10.0 * 2 * 3 * 5 * 5 * 8


def test_direction_gap_reads_the_median_leaf_angle():
    ref = {"a": torch.tensor([1.0, 0.0]), "b": torch.tensor([0.0, 2.0]),
           "c": torch.tensor([3.0, 3.0])}
    same = {k: 7.0 * v for k, v in ref.items()}  # a common scale, as the clip's
    assert tc.direction_gap(same, ref, sorted(ref)) == pytest.approx(0.0, abs=1e-12)
    turned = dict(same, a=torch.tensor([0.0, 1.0]), b=torch.tensor([1.0, 0.0]))
    assert tc.direction_gap(turned, ref, sorted(ref)) == pytest.approx(1.0)
    bad = dict(same, a=torch.tensor([float("nan"), 0.0]))
    assert tc.direction_gap(bad, ref, sorted(ref)) == float("inf")


def test_row_blocked_reference_step_equals_the_whole_batch_step():
    config, mix = tiny_conformer("float32"), tiny_mix(batch=5)
    dev = torch.device("cpu")
    batch = generate.train_pool(mix, 2**31 + 9, dev)[0]
    batch = {k: torch.from_numpy(batch[k]) for k in train_steps.KEYS}
    for k in ("wave_lengths", "labels", "label_lengths"):
        batch[k] = batch[k].long()
    w = tc.make_weights(config["model"], config["vocab_size"], 2**31 + 9, dev)
    steps = [ConformerTrainer(config["model"], w, config["train"], config["features"],
                              block_rows=rows).step(batch, 2**31 + 9) for rows in (0, 2)]
    whole, blocks = steps
    assert abs(whole["loss"] - blocks["loss"]) <= 1e-5 * abs(whole["loss"])
    assert max(abs(a - b) for a, b in zip(whole["rows"], blocks["rows"])) <= 1e-4
    for name, g in whole["grads"].items():
        assert float((g - blocks["grads"][name]).norm()) <= 1e-4 * max(float(g.norm()), 1e-3), name


# -- the control and the faults against the cell's limits ---------------------


def _run_with_limits(tmp_path):
    ctx = Ctx(tiny_conformer(), tiny_mix(), cell_limits(CELL), 2**31 + 5, tmp_path, 0.5)
    return tc.run(ctx)


def test_control_is_not_correct(tmp_path):
    """The reference with its products' operands in float8 e4m3 in the
    program's place, judged by the cell's limits."""
    ctx = Ctx(tiny_conformer("float32"), tiny_mix(batch=8), cell_limits(CELL), 2**31 + 5,
              tmp_path, 0.5)
    pool = generate.train_pool(ctx.mix, ctx.seed, ctx.device)
    ref = tc.reference_readings(ctx, pool, Precision("f32"))
    ctrl = tc.reference_readings(ctx, pool, Precision("fp8"))
    numbers, _ = tc.compare(ctrl, ref, float(ctx.mix["min_grad_share"]))
    correct, got = checks.judge(numbers, ctx.limits)
    assert not correct, numbers
    name = load("limits", CELL + ".json")["catches_control"]
    assert got[name]["value"] > got[name]["limit"], got


def test_step_over_half_of_its_batch(tmp_path, monkeypatch):
    build = port.build_train_step

    def half_batch(*a, **kw):
        state, step = build(*a, **kw)

        def broken(state, wave, wave_lengths, labels, label_lengths, seed):
            n = wave.shape[0] // 2
            return step(state, wave[:n], wave_lengths[:n], labels[:n], label_lengths[:n], seed)

        return state, broken

    monkeypatch.setattr(port, "build_train_step", half_batch)
    rec = _run_with_limits(tmp_path)
    assert not rec["correct"]
    for name in [load("limits", CELL + ".json")["catches_fault"], "utt_loss_spread"]:
        assert rec["checks"][name]["value"] > rec["checks"][name]["limit"], rec["checks"]


def test_loss_over_half_of_its_batch(tmp_path):
    from portbench import calibrate

    with calibrate.loss_over_half(True):
        rec = _run_with_limits(tmp_path)
    assert not rec["correct"]
    name = load("limits", CELL + ".json")["catches_fault"]
    assert rec["checks"][name]["value"] > rec["checks"][name]["limit"], rec["checks"]


def test_step_that_leaves_its_state_unchanged(tmp_path, monkeypatch):
    from asr_chinese_e2e_tpu_torch.train import optimizer as opt_mod

    def step(self, data_group=None):
        grads = [p.grad for p in self.params]
        self.count += 1
        return opt_mod.global_norm(grads)

    monkeypatch.setattr(opt_mod.Optimizer, "step", step)
    rec = _run_with_limits(tmp_path)
    assert not rec["correct"]
    assert rec["checks"]["change_gap"]["value"] == pytest.approx(1.0)
