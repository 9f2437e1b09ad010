"""The port's span recorder (``utils/debug.py``) on the CPU: off (no span
kept, no profiler range entered) without a profiler; under one, a
flagship-configured train step records its phases under ``train_step``
with the step's number, each span lies on its own range in the
profiler's events, the ``sync.*`` sites of a train step and of one beam
batch are counted exactly, and ``recognize``'s encode and search spans
agree with its ``timing``.

The sync counts are the CPU's: the same code reads the same tensors there,
except the attention kernels' length check (``ops/fused_attention.py``),
which runs on the card only (one sync a K1 call)."""

import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e_tpu_torch.recognize import recognize
from asr_chinese_e2e_tpu_torch.train.optimizer import (
    default_train_config,
    make_optimizer,
    model_width,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns
from asr_chinese_e2e_tpu_torch.utils import debug
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus

torch.set_num_threads(2)

VOCAB = 24
# the flagship's selections (post-LN, hash dropout with attention-weight
# dropout, the fused encoder attention, CTC 0.3, bf16, SpecAugment with one
# mask of each kind) at tiny widths
MODEL = dict(d_model=32, num_heads=4, head_dim=8, d_ff=64, num_encoder_layers=2,
             num_decoder_layers=2, norm_type="post", input_dim=80, frontend="linear",
             dropout_rate=0.1, dropout_impl="hash", attn_weight_dropout=True,
             attn_impl="fused", decoder_attn_impl="xla", ctc_weight=0.3,
             max_target_len=16, dtype="bfloat16")
FEATURES = dict(n_mels=20, lfr_m=4, lfr_n=3, freq_mask_param=4, time_mask_param=4,
                num_freq_masks=1, num_time_masks=1, fbank_impl="xla")
TRAIN = dict(spec_augment=True, lr_schedule="constant", lr=1e-3, grad_clip=5.0)
PHASES = ("train.features", "train.forward", "train.loss", "train.backward",
          "train.optimizer", "train.metric_sums")
# sync sites of one train step of MODEL on the CPU: the seed's and the
# scale's copy to the device in each hash-dropout call (the encoder's input
# and the decoder's embeddings, two a encoder layer, five a decoder layer:
# 16), SpecAugment's lengths and its two masks' copies
TRAIN_STEP_SYNCS = 2 * (2 + 2 * 2 + 5 * 2) + 1 + 2
MAX_DECODE_LEN = 6
# sync sites of one beam batch in recognize: the batch's copy, the
# encoder's sync, a finished-check and the EOS row's scalar copy each of
# the MAX_DECODE_LEN steps, and the n-best's copy back
BEAM_BATCH_SYNCS = 1 + 1 + 2 * MAX_DECODE_LEN + 1


def _profiled(fn):
    """``fn()`` under a CPU profiler, after one warm-up span (the first
    range of a profiling session is entered about a millisecond late):
    (fn's result, the spans it recorded, the profiler's events)."""
    debug.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with debug.annotate("warm_up"):
            pass
        out = fn()
    spans = [s for s in debug.spans() if s.name != "warm_up"]
    debug.clear_spans()
    return out, spans, prof.profiler.kineto_results.events()


def _batch(gen, b=3, seconds=(1.0, 0.8, 0.6)):
    n = int(16000 * max(seconds))
    wave = (torch.randn(b, n, generator=gen) * 3000).to(torch.int16)
    lengths = torch.tensor([int(16000 * s) for s in seconds], dtype=torch.int32)
    label_lengths = torch.tensor([5, 4, 3], dtype=torch.int32)
    labels = torch.randint(4, VOCAB, (b, 5), generator=gen)
    labels = labels * (torch.arange(5)[None] < label_lengths[:, None])  # PAD-padded
    return wave, lengths, labels, label_lengths


@pytest.fixture(scope="module")
def step_fns():
    cfg = default_config().build(**MODEL)
    tcfg = default_train_config().combine(cfg).build(**TRAIN)
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, opt, FeatureConfig(**FEATURES), tcfg)
    return init_fn(), train_step


def test_without_a_profiler_no_span_is_kept_or_entered(step_fns, monkeypatch):
    state, train_step = step_fns

    def refuse(*_):
        raise AssertionError("a profiler range entered with no profiler active")

    monkeypatch.setattr(debug, "_RecordFunctionFast", refuse)
    debug.clear_spans()
    train_step(state, *_batch(torch.Generator().manual_seed(1)), 3)
    with debug.annotate("outside"):
        pass
    assert debug.spans() == []


def test_a_profiled_train_step_records_its_phases(step_fns):
    state, train_step = step_fns
    number = state.step
    _, spans, _ = _profiled(
        lambda: train_step(state, *_batch(torch.Generator().manual_seed(2)), 3))
    root = [s for s in spans if s.name == "train_step"]
    assert len(root) == 1 and root[0].parent is None and root[0].request == number
    phases = [s for s in spans if s.name.startswith("train.")]
    assert tuple(s.name for s in phases) == PHASES
    for s in spans[1:]:
        assert s.request == number
        assert root[0].start_ns <= s.start_ns <= s.end_ns <= root[0].end_ns
    assert all(s.parent is root[0] for s in phases)
    for s in spans:  # every sync lies inside a phase
        if s.name.startswith("sync."):
            assert s.parent.name in PHASES, s
    assert sum(s.name.startswith("sync.") for s in spans) == TRAIN_STEP_SYNCS


def test_spans_lie_on_their_ranges_in_the_profilers_events(step_fns):
    state, train_step = step_fns
    _, spans, events = _profiled(
        lambda: train_step(state, *_batch(torch.Generator().manual_seed(4)), 3))
    names = {s.name for s in spans}
    ranges = {}
    for e in events:
        if e.name() in names:
            ranges.setdefault(e.name(), []).append(e)
    for name, evs in ranges.items():
        mine = [s for s in spans if s.name == name]
        evs.sort(key=lambda e: e.start_ns())
        assert len(evs) == len(mine), name
        for s, e in zip(mine, evs):
            assert abs(s.start_ns - e.start_ns()) < 100_000, (name, s.start_ns - e.start_ns())
            end = e.start_ns() + e.duration_ns()
            assert abs(s.end_ns - end) < 100_000, (name, s.end_ns - end)


def test_spans_nest_per_thread_and_inherit_the_request():
    def work():
        with debug.annotate("outer", request=7):
            with debug.annotate("inner"):
                with debug.annotate("sync.x"):
                    pass
            with debug.annotate("other", request=8):
                pass

    _, spans, _ = _profiled(work)
    outer, inner, sync, other = spans
    assert (outer.parent, inner.parent, sync.parent, other.parent) == (None, outer, inner, outer)
    assert [s.request for s in spans] == [7, 7, 7, 8]
    assert all(s.start_ns <= s.end_ns for s in spans)
    seen = []
    t = threading.Thread(target=lambda: seen.append(getattr(debug._OPEN, "stack", None)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and seen == [None]


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    corpus = make_synth_corpus(str(root / "corpus"), n_train=0, n_dev=0, n_test=5,
                               n_tone_chars=6, vocab_size=VOCAB, seconds_range=(0.6, 1.2),
                               tone_sec=0.3, seed=0)
    vocab = Vocab.load(corpus["vocab"])
    cfg = dict(MODEL, **FEATURES, input_dim=FEATURES["n_mels"] * FEATURES["lfr_m"])
    model = SpeechTransformer(default_config().build(**cfg), vocab.vocab_size,
                              torch.Generator().manual_seed(5))
    exp = root / "exp"
    exp.mkdir()
    Config(**cfg).save(str(exp / "config.json"))
    save_torch_checkpoint(str(exp), model.state_dict(), vocab.fingerprint(), "best")
    return str(exp), corpus


def _decode(experiment, **kw):
    exp, corpus = experiment
    return recognize(exp, corpus["vocab"], manifest=corpus["test"], device="cpu",
                     mode="beam", beam_size=3, max_decode_len=MAX_DECODE_LEN, **kw)


def test_one_beam_batch_counts_its_syncs(experiment):
    _decode(experiment, batch_size=8)  # loads the experiment
    res, spans, _ = _profiled(lambda: _decode(experiment, batch_size=8))
    assert res["timing"]["batches"] == 1
    steps = [s for s in spans if s.name == "beam.step"]
    assert len(steps) == MAX_DECODE_LEN
    assert all(s.parent.name == "recognize.search" for s in steps)
    assert sum(s.name.startswith("sync.") for s in spans) == BEAM_BATCH_SYNCS
    root = [s for s in spans if s.name == "recognize"]
    assert len(root) == 1 and all(s.request == root[0].request for s in spans)


def test_encode_and_search_spans_agree_with_timing(experiment):
    _decode(experiment, batch_size=2)
    calls = []
    res, spans, _ = _profiled(lambda: calls.extend(_decode(experiment, batch_size=2)
                                                   for _ in range(2)))
    timing = {k: sum(c["timing"][k] for c in calls) for k in ("encode_s", "search_s", "batches")}
    total = lambda *names: sum(s.end_ns - s.start_ns for s in spans if s.name in names) / 1e9
    assert sum(s.name == "recognize.dispatch" for s in spans) == timing["batches"] == 6
    assert total("recognize.encode") == pytest.approx(timing["encode_s"], abs=1e-3)
    # timing's search_s holds each batch's search and its drain
    assert total("recognize.search", "recognize.drain") == pytest.approx(timing["search_s"],
                                                                         abs=1e-3)
    roots = [s for s in spans if s.name == "recognize"]
    assert len(roots) == 2 and roots[1].request == roots[0].request + 1
    # the waits on the batches, one more than the batches (the end)
    assert sum(s.name == "recognize.next_batch" for s in spans) == 6 + 2


def test_a_beam_search_alone_counts_a_sync_a_step():
    cfg = default_config().build(**MODEL)
    model = SpeechTransformer(cfg, VOCAB, torch.Generator().manual_seed(6)).eval()
    enc = torch.randn(2, 9, MODEL["d_model"], generator=torch.Generator().manual_seed(7))
    lens = torch.tensor([9, 5])
    result, spans, _ = _profiled(lambda: beam_search(model, enc, lens, 3, MAX_DECODE_LEN))
    assert [s.name for s in spans] == (
        ["beam.step", "sync.beam.finished", "sync.beam.eos_row"] * MAX_DECODE_LEN)
    _, spans, _ = _profiled(result.materialize)
    assert [s.name for s in spans] == ["sync.beam.materialize"]
