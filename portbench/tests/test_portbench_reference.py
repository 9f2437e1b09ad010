"""The plain reference against the port's plain CPU path at tiny widths, in
float32: the drivers' own comparisons come out at rounding. (On the CPU
the port's kernel wrappers run their plain versions; the program's
dropout, SpecAugment, losses, clip and Adam are the port's.)"""

from __future__ import annotations

import pytest

from conftest import tiny_config, tiny_mix
from portbench.drivers import recognize_calls, train_steps


@pytest.mark.parametrize("name", ["ref-transformer", "large-transformer"])
def test_train_step_follows_the_program(make_ctx, name):
    ctx = make_ctx(tiny_config(name, "float32"), tiny_mix("aishell-train"))
    rec = train_steps.run(ctx)
    got = {k: v["value"] for k, v in rec["checks"].items()}
    assert got["loss_gap"] < 1e-5, got
    assert got["grad_gap"] < 5e-3, got
    assert got["change_gap"] < 5e-3, got
    assert rec["attempted"] > 0 and rec["failed"] == 0


def test_attention_beam_follows_the_program(make_ctx):
    ctx = make_ctx(tiny_config("ref-transformer", "float32"), tiny_mix("offline-beam-fill"))
    rec = recognize_calls.run(ctx)
    got = {k: v["value"] for k, v in rec["checks"].items()}
    assert got["score_gap"] < 1e-4, got


def test_rescore_follows_the_program(make_ctx):
    ctx = make_ctx(tiny_config("large-transformer", "float32"), tiny_mix("online-rescore"))
    rec = recognize_calls.run(ctx)
    got = {k: v["value"] for k, v in rec["checks"].items()}
    assert got["ctc_lp_gap"] < 1e-4 and got["nbest_misses"] == 0, got
    assert got["rescore_att_gap"] < 1e-4, got


@pytest.mark.parametrize("case", range(12))
def test_prefix_beam_equals_the_programs_plain_search(case):
    """The reference's float32 prefix beam against the port's plain version
    of K9 on flat, scaled and blank-heavy log-probs, full prefixes too:
    the same n-best, scores equal to the last bit."""
    import torch

    from portbench.reference.decode import ctc_prefix_beam

    from asr_chinese_e2e_tpu_torch.decode.ctc_prefix_device import (
        ctc_prefix_beam_reference,
        device_nbest_to_lists,
    )

    g = torch.Generator().manual_seed(case)
    t, v = (40, 150, 200)[case % 3], (60, 4233)[case % 2]
    x = torch.randn(1, t, v, generator=g) * (1.0, 4.0)[case % 4 // 2]
    if case % 5 == 0:
        x[..., 0] += 6.0
    lp = torch.log_softmax(x, -1)
    cap = 8 if case % 6 == 1 else 64
    want = device_nbest_to_lists(*ctc_prefix_beam_reference(lp, torch.tensor([t]), 10, 8, cap))[0]
    assert ctc_prefix_beam(lp[0], 10, 8, cap) == want
