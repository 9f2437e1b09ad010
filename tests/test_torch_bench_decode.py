"""The port's decode bench and decode profile on the CPU at tiny widths
(``scripts/bench_decode_torch.py``, ``scripts/profile_torch_decode.py``;
the kernels' plain versions, since the tensors are on the CPU).

- ``main``: ``lazy`` and ``gather`` give the same tokens (f32: the same
  scores too; bf16 as the flagship runs), ``joint`` runs, each with
  positive times.
- ``sweep`` (``corpus`` per mode and pipeline depth through the port's
  ``recognize``): the same ``utts`` at depths 0 and 1, positive encode and
  search seconds, one untrained experiment saved once and reused.
- The decode profile: every component timed, and the traced search's
  decode steps and operators, in each mode.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import bench_decode_torch  # noqa: E402
import profile_torch_decode  # noqa: E402

TINY = dict(d_model=16, num_heads=2, head_dim=8, d_ff=32, num_encoder_layers=1,
            num_decoder_layers=2)
SHAPE = dict(batch=3, seconds=1.0, beam=4, max_len=6, vocab_size=50, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Tiny models are many small operations: with every core's thread
    spinning on each, test files side by side starve one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_main_lazy_and_gather_give_the_same_tokens(dtype, capsys):
    out = bench_decode_torch.main(n_iters=1, dtype=dtype, **SHAPE, **TINY)
    assert list(out) == ["lazy", "gather", "joint"]
    for r in out.values():
        assert r["tokens"].shape == (3, 4, 6) and np.isfinite(r["scores"]).all()
        assert r["ms_per_batch"] > 0 and r["audio_s_per_s"] > 0
    np.testing.assert_array_equal(out["lazy"]["tokens"], out["gather"]["tokens"])
    if dtype == "float32":
        np.testing.assert_allclose(out["lazy"]["scores"], out["gather"]["scores"],
                                   rtol=1e-5, atol=1e-5)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "decode" and line["card"] == "cpu"
    assert set(line["modes"]) == set(out)


def test_sweep_depths_give_the_same_utts(tmp_path, capsys):
    exp = tmp_path / "exp"
    rows = bench_decode_torch.sweep(
        seconds=1.0, batch=2, beam=3, max_len=5, n_batches=2, modes="beam,joint",
        depths="0,1", corpus_dir=str(tmp_path / "corpus"), exp_dir=str(exp), device="cpu",
        **TINY)
    assert [(r["mode"], r["pipeline_depth"]) for r in rows] == [
        ("beam", 0), ("beam", 1), ("joint", 0), ("joint", 1)]
    assert rows[0]["utts"] == rows[1]["utts"] and rows[2]["utts"] == rows[3]["utts"]
    for r in rows:
        assert r["n_utts"] == 4 and r["card"] == "cpu"
        assert min(r["wall_s"], r["audio_s_per_s"], r["encode_s"], r["search_s"]) > 0
    index = json.loads((exp / "checkpoints" / "index.json").read_text())
    assert index["all"] == ["e0_s0"] and (exp / "torch_checkpoints" / "best.pt").exists()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "decode_sweep" and len(line["rows"]) == 4
    assert "utts" not in line["rows"][0]


@pytest.mark.parametrize("mode", ["lazy", "gather", "joint"])
def test_decode_profile(mode, tmp_path, capsys):
    out = profile_torch_decode.main(n=1, top=5, mode=mode, trace_dir=str(tmp_path), **SHAPE,
                                    **TINY)
    comps = out["components"]
    assert len(comps) == 7 and all(np.isfinite(v) and v > 0 for v in comps.values())
    assert any(k.startswith("stable top-k (3, 200)") for k in comps)
    tr = out["trace"]
    assert tr["mode"] == mode and 1 <= tr["steps"] <= 6 and tr["wall_ms"] > 0
    assert tr["device_ms"] is None and tr["busy"] is None  # no card
    assert tr["ops"] and not tr["kernels"]
    assert list(tmp_path.glob("trace_*.json"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["bench"] == "profile_decode" and line["trace"]["steps"] == tr["steps"]
