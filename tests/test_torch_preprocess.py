"""The port's preprocess CLI against the root ``preprocess.py`` of the JAX
package on the CPU: ``extract``, ``build`` and ``pipeline`` on the
``tests/test_extract.py`` fixture give the same tree, manifests and vocab;
``features`` gives the same rows and, at 1e-4 abs (the port's feature
tolerance), the same features as JAX's; the CLI runs each command."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import preprocess as jax_preprocess
from asr_chinese_e2e_tpu.data.extract import extract_aishell1 as jax_extract_aishell1
from asr_chinese_e2e_tpu_torch import preprocess
from asr_chinese_e2e_tpu_torch.data.extract import extract_aishell1
from asr_chinese_e2e_tpu_torch.data.manifest import read_manifest
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.test_batching import setup_data
from tests.test_extract import _make_fixture

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _tree(root: Path) -> dict:
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _same_outputs(ours: Path, theirs: Path) -> None:
    """Equal trees, with each manifest's paths taken relative to its root."""
    a, b = _tree(ours), _tree(theirs)
    assert a.keys() == b.keys()
    for name in a:
        if name.endswith(".jsonl"):
            rel = [{**r, "wave": os.path.relpath(r["wave"], root)}
                   for r, root in ((r, ours) for r in read_manifest(str(ours / name)))]
            want = [{**r, "wave": os.path.relpath(r["wave"], theirs)}
                    for r in read_manifest(str(theirs / name))]
            assert rel == want, name
        else:
            assert a[name] == b[name], name


@pytest.mark.parametrize("remove_inner", [True, False])
def test_extract_copy_matches_original(tmp_path, remove_inner):
    outer = _make_fixture(tmp_path)
    ours = extract_aishell1(str(outer), str(tmp_path / "ours"), remove_inner=remove_inner)
    theirs = jax_extract_aishell1(str(outer), str(tmp_path / "theirs"),
                                  remove_inner=remove_inner)
    assert os.path.relpath(ours, tmp_path / "ours") == os.path.relpath(theirs, tmp_path / "theirs")
    _same_outputs(tmp_path / "ours", tmp_path / "theirs")


def test_build_and_pipeline_match_the_root_cli(tmp_path):
    outer = _make_fixture(tmp_path)
    preprocess.pipeline(str(outer), str(tmp_path / "ours"))
    jax_preprocess.pipeline(str(outer), str(tmp_path / "theirs"))
    _same_outputs(tmp_path / "ours", tmp_path / "theirs")
    # build alone over an extracted tree
    preprocess.build(str(tmp_path / "ours" / "data_aishell"), str(tmp_path / "b1"))
    jax_preprocess.build(str(tmp_path / "ours" / "data_aishell"), str(tmp_path / "b2"))
    assert _tree(tmp_path / "b1") == _tree(tmp_path / "b2")
    assert {"train.jsonl", "dev.jsonl", "test.jsonl", "vocab.json"} <= set(_tree(tmp_path / "b1"))


def test_features_match_the_root_cli(tmp_path):
    """On the synthetic corpus (tones over noise, 0.6-1.5 s). On a pure sine
    (``tests/test_batching.py::setup_data``'s waves) the bands far from the
    tone hold ~1e-8 of the energy and the two float32 log-mels there differ
    by up to 2.3e-4 after CMVN: the 1e-4 tolerance is for speech-like
    waves, as in ``tests/test_torch_features.py``."""
    mpath = make_synth_corpus(str(tmp_path / "corpus"), n_train=8, n_dev=1, n_test=1,
                              n_tone_chars=6, vocab_size=20, seconds_range=(0.6, 1.5),
                              seed=0)["train"]
    ours = preprocess.features(mpath, str(tmp_path / "ours"), n_mels=20, batch_size=3,
                               device="cpu")
    jax_preprocess.features(mpath, str(tmp_path / "theirs"), n_mels=20, batch_size=3)
    got = read_manifest(ours)
    want = read_manifest(str(tmp_path / "theirs" / "manifest.jsonl"))
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert (a["wave"], a["tgt"], a["frames"]) == (b["wave"], b["tgt"], b["frames"])
        assert os.path.basename(a["feature"]) == os.path.basename(b["feature"])
        x, y = np.load(a["feature"]), np.load(b["feature"])
        assert x.dtype == np.float32 and x.shape == y.shape == (a["frames"], 80)
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=0)


def test_cli_runs_each_command(tmp_path):
    outer = _make_fixture(tmp_path)
    run = [sys.executable, "-m", "asr_chinese_e2e_tpu_torch.preprocess"]
    for words in (["extract", "--archive", str(outer), "--out", str(tmp_path / "e")],
                  ["build", "--root", str(tmp_path / "e" / "data_aishell"),
                   "--out", str(tmp_path / "e")]):
        proc = subprocess.run(run + words, cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "e" / "vocab.json").is_file()
    mpath, _ = setup_data(tmp_path, n_short=2, n_long=0)
    proc = subprocess.run(run + ["features", "--manifest", mpath, "--out",
                                 str(tmp_path / "f"), "--n_mels", "20", "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(read_manifest(str(tmp_path / "f" / "manifest.jsonl"))) == 2
    # the card unless the caller asks for the CPU
    proc = subprocess.run(run + ["features", "--manifest", mpath, "--out",
                                 str(tmp_path / "g")],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    if not torch.cuda.is_available():
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
