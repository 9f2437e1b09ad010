"""A run with the timed path broken underneath comes out not correct, under
each cell's own limits: a train step that leaves its state unchanged, a
train step over half of its batch (the mean over that half), and a served
token altered where it is produced (the attention beam's best hypothesis,
the rescoring's pick). The drivers run on the CPU at tiny widths, past
the harness's look for a card. (No cell spans chips, so no exchange
between chips can be left out.)"""

from __future__ import annotations

import pytest
import torch

from conftest import cell_limits, few_clips, full_config, tiny_config, tiny_mix
from portbench import port
from portbench.drivers import recognize_calls, train_steps

from asr_chinese_e2e_tpu_torch.decode import beam as beam_mod
from asr_chinese_e2e_tpu_torch.decode import ctc_prefix
from asr_chinese_e2e_tpu_torch.train import optimizer as opt_mod

TRAIN_CELLS = [("train.ref-transformer.aishell-fill", "ref-transformer", "aishell-train-fill"),
               ("train.large-transformer.aishell", "large-transformer", "aishell-train")]


def _train(make_ctx, cell, config, mix):
    return train_steps.run(make_ctx(tiny_config(config), tiny_mix(mix), cell_limits(cell)))


@pytest.mark.parametrize("cell,config,mix", TRAIN_CELLS)
def test_step_that_leaves_its_state_unchanged(make_ctx, monkeypatch, cell, config, mix):
    def step(self, data_group=None):
        grads = [p.grad for p in self.params]
        self.count += 1
        return opt_mod.global_norm(grads)

    monkeypatch.setattr(opt_mod.Optimizer, "step", step)
    rec = _train(make_ctx, cell, config, mix)
    assert not rec["correct"]
    assert rec["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell,config,mix", TRAIN_CELLS)
def test_step_over_half_of_its_batch(make_ctx, monkeypatch, cell, config, mix):
    build = port.build_train_step

    def half_batch(*a, **kw):
        state, step = build(*a, **kw)

        def broken(state, wave, wave_lengths, labels, label_lengths, seed):
            n = wave.shape[0] // 2
            return step(state, wave[:n], wave_lengths[:n], labels[:n], label_lengths[:n], seed)

        return state, broken

    monkeypatch.setattr(port, "build_train_step", half_batch)
    rec = _train(make_ctx, cell, config, mix)
    assert not rec["correct"]
    assert rec["checks"]["loss_gap"]["value"] > rec["checks"]["loss_gap"]["limit"]


def _altered(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """Each token id >= 4 moved to the next one (EOS and the specials kept)."""
    return torch.where(ids >= 4, 4 + (ids - 3) % (vocab - 4), ids)


def test_beam_answer_altered_where_produced(make_ctx, monkeypatch):
    """At the flagship's widths and the mix's beam (two clips): the best
    hypothesis's tokens altered, its score left as the search made it."""
    search = beam_mod.beam_search

    def broken(model, *a, **kw):
        res = search(model, *a, **kw)
        res.tokens[:, 0] = _altered(res.tokens[:, 0], model.vocab_size)
        return res

    from asr_chinese_e2e_tpu_torch import recognize as rec_mod

    monkeypatch.setattr(rec_mod, "beam_search", broken)
    rec = recognize_calls.run(make_ctx(full_config("ref-transformer"), few_clips("offline-beam-fill", 2),
                                       cell_limits("offline.ref-transformer.beam-fill")))
    assert not rec["correct"]
    assert rec["checks"]["score_gap"]["value"] > rec["checks"]["score_gap"]["limit"]


def test_rescore_pick_altered_where_produced(make_ctx, monkeypatch):
    rescore = ctc_prefix.attention_rescore

    def broken(model, *a, **kw):
        best = rescore(model, *a, **kw)
        return [_altered(torch.tensor(b or [4]), model.vocab_size).tolist() for b in best]

    from asr_chinese_e2e_tpu_torch import recognize as rec_mod

    monkeypatch.setattr(rec_mod, "attention_rescore", broken)
    rec = recognize_calls.run(make_ctx(tiny_config("large-transformer"),
                                       tiny_mix("online-rescore"),
                                       cell_limits("online.large-transformer.rescore")))
    assert not rec["correct"]
    assert rec["checks"]["nbest_misses"]["value"] >= 1
