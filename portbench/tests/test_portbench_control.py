"""The control of ``correct``: the plain reference put in the program's
place with its products' operands in float8 e4m3 (the step below the
configurations' bfloat16) comes out not correct under each cell's limits.
Here at tiny widths on the CPU; ``portbench/calibrate.py --control`` reads
it on the card at the cells' own sizes."""

from __future__ import annotations

import pytest
import torch

from conftest import cell_limits, few_clips, full_config, load, tiny_config, tiny_mix
from portbench import checks, generate
from portbench.drivers import recognize_calls, train_steps
from portbench.reference.precision import Precision


@pytest.mark.parametrize("cell,config,mix", [
    ("train.ref-transformer.aishell-fill", "ref-transformer", "aishell-train-fill"),
    ("train.large-transformer.aishell", "large-transformer", "aishell-train")])
def test_train_control_is_not_correct(make_ctx, cell, config, mix):
    ctx = make_ctx(tiny_config(config), tiny_mix(mix), cell_limits(cell))
    pool = generate.train_pool(ctx.mix, ctx.seed, ctx.device)
    ref = train_steps.reference_readings(ctx, pool, Precision("f32"))
    ctrl = train_steps.reference_readings(ctx, pool, Precision("fp8"))
    numbers, _ = train_steps.compare(ctrl, ref, float(ctx.mix["min_grad_share"]))
    correct, _ = checks.judge(numbers, ctx.limits)
    assert not correct, numbers


@pytest.mark.parametrize("cell,config,mix", [
    ("offline.ref-transformer.beam-fill", "ref-transformer", "offline-beam-fill"),
    ("online.large-transformer.rescore", "large-transformer", "online-rescore")])
def test_decode_control_is_not_correct(make_ctx, cell, config, mix):
    """The beam at the flagship's own widths and search over as many clips
    as a run judges (16): at tiny widths five steps of a 60-token
    vocabulary say nothing of 40 of 4233. The rescore cell's start is judged
    per frame, so tiny widths do there."""
    if mix == "offline-beam-fill":
        n = load("traffic", mix + ".json")["check_sample"]
        ctx = make_ctx(full_config(config), few_clips(mix, n), cell_limits(cell))
    else:
        ctx = make_ctx(tiny_config(config), tiny_mix(mix), cell_limits(cell))
    clips = generate.clips(ctx.mix, ctx.seed, ctx.device)[: ctx.mix["check_sample"]]
    items = recognize_calls.control_items(ctx, clips, Precision("fp8"))
    numbers, _ = recognize_calls.judge_decode(ctx, items, Precision("f32"))
    correct, _ = checks.judge(numbers, ctx.limits)
    assert not correct, numbers


def test_fp8_rounds_to_e4m3_with_a_tensor_scale():
    x = torch.tensor([1.0, 0.3, -448.0, 1e-3])
    y = Precision("fp8")(x)
    assert y[2] == -448.0 and y[0] == 1.0
    assert abs(float(y[1]) - 0.3) > 1e-4
    assert torch.equal(Precision("f32")(x), x)


def test_a_number_marked_not_compared_is_left_out():
    limits = {"a": {"limit": 1.0}, "b": {"compared": False, "why": "no upper reading"}}
    correct, got = checks.judge({"a": 0.5, "b": 9.0}, limits)
    assert correct and set(got) == {"a"}
    correct, got = checks.judge({"a": 0.5, "b": 9.0, "c": 0.1}, limits)
    assert not correct and got["c"]["limit"] is None
