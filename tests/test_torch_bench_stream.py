"""The port's stream bench (``scripts/bench_stream_torch.py``) on the CPU at
tiny widths: a row per (mode, bucket) with positive partial and final
times, the printed table, and the incremental arm in each mode; its
segments are the JAX script's draws (``scripts/bench_stream.py``: the
init wave, then one segment per bucket from the same ``RandomState``)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.utils.synth import char_freqs as jax_char_freqs
from asr_chinese_e2e_tpu.utils.synth import synth_wave as jax_synth_wave
from asr_chinese_e2e_tpu.utils.synth import tone_chars as jax_tone_chars

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import bench_stream_torch  # noqa: E402

TINY = dict(d_model=16, num_heads=2, head_dim=8, d_ff=32, num_encoder_layers=1,
            num_decoder_layers=1)
MODES = ["ctc_greedy", "beam", "joint"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny models are many small operations: with every core's thread
    spinning on each, test files side by side starve one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_stream_bench_rows_and_incremental_arm(capsys):
    out = bench_stream_torch.main(n_iters=1, bucket_seconds="1,2", beam=3, max_len=5,
                                  vocab_size=100, device="cpu", **TINY)
    assert [(m, s) for m, s, _, _ in out["rows"]] == [(m, s) for m in MODES for s in (1.0, 2.0)]
    assert all(np.isfinite(p) and p > 0 and np.isfinite(f) and f > 0
               for _, _, p, f in out["rows"])
    assert [r["mode"] for r in out["incremental"]] == MODES
    for r in out["incremental"]:
        assert r["seg_s"] == 2.0
        assert all(np.isfinite(r[k]) and r[k] > 0
                   for k in ("partial_mean_ms", "partial_p95_ms", "final_ms"))
    lines = capsys.readouterr().out.strip().splitlines()
    head = lines.index("mode | bucket | partial ms | final ms")
    assert [ln.split(" | ")[:2] for ln in lines[head + 1:head + 7]] == [
        [m, f"{s}s"] for m in MODES for s in (1, 2)]
    line = json.loads(lines[-1])
    assert line["bench"] == "stream" and line["card"] == "cpu" and len(line["rows"]) == 6


def test_segments_follow_the_jax_bench_draws():
    sr = 16000
    chars, freqs = jax_tone_chars(40), jax_char_freqs(40)
    theirs, ours = np.random.RandomState(0), np.random.RandomState(0)
    theirs.randn(2, sr)
    ours.randn(2, sr)
    for sec in (2.0, 4.0, 8.0):
        text = "".join(chars[theirs.randint(40)] for _ in range(max(1, int(sec / 0.3))))
        want = (jax_synth_wave(text, chars, freqs, theirs) * 32767).astype(np.int16)[: int(sec * sr)]
        got = bench_stream_torch._segment(chars, freqs, ours, sec, sr)
        np.testing.assert_array_equal(got, want)
