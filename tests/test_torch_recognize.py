"""The port's serving slice end to end against the JAX pipeline, the port's
independence from JAX, and its copies of the JAX package's host modules.

- ``recognize`` on a tiny synthetic corpus (fbank kernel and fused
  attention selected, as on the flagship) gives the same n-best text as
  JAX's ``batched`` -> ``parse_batch`` -> ``encode`` -> the mode's search on
  the same weights, scores within 1e-4, in every mode (``ctc_greedy``,
  ``attention_greedy``, ``beam``, ``rescore`` with the device and the host
  prefix beam, ``joint``; ``beam`` and ``joint`` also on a conformer with
  the conv2d frontend), and the same n-best JSON for pipeline depths 0,
  1 and 2; an unknown mode and mesh decode raise.
- Every port module imports with jax, flax, optax and orbax blocked, and
  the JAX package never enters ``sys.modules``; an AST scan of the
  sources backs that up.
- The copied host modules (vocab, manifest, CER, CLI parsing, config, wav
  reading, synthetic corpus) agree with their originals on the same
  inputs.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recognize as jax_recognize
from asr_chinese_e2e_tpu.core.config import Config as JaxConfig
from asr_chinese_e2e_tpu.data.batching import load_wav as jax_load_wav
from asr_chinese_e2e_tpu.data.features import parse_batch as jax_parse_batch
from asr_chinese_e2e_tpu.data.manifest import read_manifest as jax_read_manifest
from asr_chinese_e2e_tpu.data.vocab import Vocab as JaxVocab
from asr_chinese_e2e_tpu.decode import ctc_prefix as jax_prefix
from asr_chinese_e2e_tpu.decode import ctc_prefix_device as jax_prefix_device
from asr_chinese_e2e_tpu.decode import greedy as jax_greedy
from asr_chinese_e2e_tpu.decode.beam import beam_search as jax_beam_search
from asr_chinese_e2e_tpu.decode.joint import joint_beam_search as jax_joint_beam_search
from asr_chinese_e2e_tpu.decode.cer import corpus_cer as jax_corpus_cer
from asr_chinese_e2e_tpu.utils.cli import parse_kwargs as jax_parse_kwargs
from asr_chinese_e2e_tpu.utils.experiment import (
    feature_config_from as jax_feature_config_from,
)
from asr_chinese_e2e_tpu.utils.synth import make_synth_corpus as jax_make_synth_corpus
from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.io import load_wav
from asr_chinese_e2e_tpu_torch.data.manifest import read_manifest
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.decode.cer import corpus_cer
from asr_chinese_e2e_tpu_torch import recognize as rec_mod
from asr_chinese_e2e_tpu_torch.recognize import recognize
from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests.test_torch_model import model_pair, tiny_config

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "asr_chinese_e2e_tpu_torch"
CORPUS_KW = dict(
    n_train=0, n_dev=0, n_test=6, n_tone_chars=6, vocab_size=20,
    seconds_range=(0.6, 2.4), tone_sec=0.3, seed=0,
)


def _slice_config():
    """Tiny model with the flagship's kernel selections."""
    return tiny_config(
        input_dim=80, n_mels=20, fbank_impl="pallas", attn_impl="fused"
    )


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """(exp dir, corpus paths, jax model, flax params): a port checkpoint
    saved as ``latest`` only, so loading ``best`` exercises the fallback."""
    root = tmp_path_factory.mktemp("torch_recognize")
    corpus = make_synth_corpus(str(root / "corpus"), **CORPUS_KW)
    vocab = Vocab.load(corpus["vocab"])
    jcfg = _slice_config()
    jm, params, tm = model_pair(jcfg, vocab_size=vocab.vocab_size, seed=2)
    exp = root / "exp"
    exp.mkdir()
    Config(**jcfg.to_dict()).save(str(exp / "config.json"))
    save_torch_checkpoint(str(exp), tm.state_dict(), vocab.fingerprint(), "latest")
    return str(exp), corpus, jm, params, jcfg


def _jax_search(mode, jm, params, enc, enc_len, kw):
    """JAX's per-batch n-best [(ids, score)] of ``mode``, as its
    ``recognize`` drains it."""
    if mode == "ctc_greedy":
        lp = jm.apply(params, enc, method="ctc_log_probs")
        return [[(ids, 0.0)] for ids in jax_greedy.ctc_greedy_decode(lp, enc_len)]
    if mode == "attention_greedy":
        tokens, scores = jax_greedy.attention_greedy_decode(
            jm, params, enc, enc_len, kw["max_decode_len"])
        return [[(ids, float(s))] for ids, s in
                zip(jax_greedy.tokens_to_ids(tokens), np.asarray(scores))]
    if mode.startswith("rescore"):
        lp = jm.apply(params, enc, method="ctc_log_probs")
        if mode == "rescore-device":
            nbest = jax_prefix_device.device_nbest_to_lists(
                *jax_prefix_device.ctc_prefix_beam_device(lp, enc_len, beam_size=kw["beam_size"]))
        else:
            nbest = jax_prefix.ctc_prefix_beam_batch(
                np.asarray(lp), np.asarray(enc_len), kw["beam_size"])
        best = jax_prefix.attention_rescore(jm, params, enc, enc_len, nbest, 0.3)
        return [[(ids, 0.0)] for ids in best]
    if mode == "beam":
        r = jax_beam_search(jm, params, enc, enc_len, kw["beam_size"], kw["max_decode_len"])
    else:
        r = jax_joint_beam_search(jm, params, enc, enc_len, kw["beam_size"],
                                  kw["max_decode_len"], ctc_weight=0.3, ctc_prune=6)
    ids = r.nbest_ids(kw["nbest"])
    return [[(h, float(r.scores[b, k])) for k, h in enumerate(ids[b])]
            for b in range(len(ids))]


RECOGNIZE_MODES = {
    "ctc_greedy": {}, "attention_greedy": {}, "beam": {},
    "rescore-device": dict(mode="rescore", ctc_beam_impl="device"),
    "rescore-host": dict(mode="rescore", ctc_beam_impl="host"),
    "joint": dict(ctc_prune=6),
}


@pytest.fixture(scope="module")
def conformer_experiment(tmp_path_factory):
    """The same for a conformer with the conv2d frontend. Its config keeps
    ``input_dim``'s default (320) as a JAX experiment's does, while the
    features are 80 wide: the projection's width follows the features."""
    root = tmp_path_factory.mktemp("torch_recognize_conformer")
    corpus = make_synth_corpus(str(root / "corpus"), **CORPUS_KW)
    vocab = Vocab.load(corpus["vocab"])
    jcfg = _slice_config().build(encoder_type="conformer", norm_type="pre",
                                 frontend="conv2d", conv_kernel_size=5)
    jm, params, tm = model_pair(jcfg, vocab_size=vocab.vocab_size, seed=2)
    exp = root / "exp"
    exp.mkdir()
    Config(**jcfg.to_dict()).build(input_dim=320).save(str(exp / "config.json"))
    save_torch_checkpoint(str(exp), tm.state_dict(), vocab.fingerprint(), "latest")
    return str(exp), corpus, jm, params, jcfg


def _recognize_matches_jax(experiment, tmp_path, mode):
    exp, corpus, jm, params, jcfg = experiment
    kw = dict(beam_size=3, batch_size=4, max_decode_len=8, nbest=2)
    out = tmp_path / "res.json"
    port_kw = {"mode": mode, **RECOGNIZE_MODES[mode]}
    res = recognize(exp, corpus["vocab"], manifest=corpus["test"], device="cpu",
                    out=str(out), **kw, **port_kw)

    voc = JaxVocab.load(corpus["vocab"])
    feat_cfg = jax_feature_config_from(jcfg)
    records = jax_read_manifest(corpus["test"])
    want, n_batches = {}, 0
    for chunk, wave, lengths in jax_recognize.batched(
        records, kw["batch_size"], int(15.0 * 16000), 16000
    ):
        feats, fl = jax_parse_batch(jnp.asarray(wave), jnp.asarray(lengths), feat_cfg)
        enc, enc_len = jm.apply(params, feats, fl, method="encode")
        nbest = _jax_search(mode, jm, params, enc, enc_len, kw)
        n_batches += 1
        for b, rec in enumerate(chunk):
            utt = rec["wave"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
            want[utt] = [("".join(voc.ids_to_tokens(h)), s) for h, s in nbest[b]]

    assert set(res["utts"]) == set(want)
    for utt, hyps in want.items():
        got = res["utts"][utt]["output"]
        assert [g["rec_text"] for g in got] == [h[0] for h in hyps]
        np.testing.assert_allclose(
            [g["score"] for g in got], [h[1] for h in hyps], atol=1e-4, rtol=0
        )
        assert all("text" in g for g in got)
    if mode in ("beam", "joint", "attention_greedy"):
        assert any(any(h[1] != 0.0 for h in hyps) for hyps in want.values())
    hyps = [res["utts"][u]["output"][0]["rec_text"] for u in want]
    refs = [res["utts"][u]["output"][0]["text"] for u in want]
    assert res["cer"] == pytest.approx(jax_corpus_cer(hyps, refs))
    written = json.loads(out.read_text(encoding="utf-8"))
    assert set(written) == {"utts", "cer"}
    assert res["timing"]["batches"] == n_batches


@pytest.mark.parametrize("mode", list(RECOGNIZE_MODES))
def test_recognize_matches_jax_pipeline(experiment, tmp_path, mode):
    _recognize_matches_jax(experiment, tmp_path, mode)


@pytest.mark.parametrize("mode", ["beam", "joint"])
def test_conformer_recognize_matches_jax_pipeline(conformer_experiment, tmp_path, mode):
    _recognize_matches_jax(conformer_experiment, tmp_path, mode)


@pytest.mark.parametrize("mode", ["beam", "joint", "ctc_greedy"])
def test_pipeline_depth_gives_the_same_json(experiment, tmp_path, mode):
    exp, corpus, *_ = experiment
    written = []
    for depth in (0, 1, 2):
        out = tmp_path / f"res{depth}.json"
        recognize(exp, corpus["vocab"], manifest=corpus["test"], device="cpu", mode=mode,
                  beam_size=3, batch_size=2, max_decode_len=6, nbest=2, ctc_prune=6,
                  pipeline_depth=depth, out=str(out))
        written.append(out.read_text(encoding="utf-8"))
    assert written[0] == written[1] == written[2]
    assert len(json.loads(written[0])["utts"]) == CORPUS_KW["n_test"]


@pytest.mark.parametrize("kw,error", [
    (dict(mode="greedy"), SystemExit),
    (dict(mode="beam", mesh_data=2), SystemExit),
])
def test_recognize_refuses_unknown_modes_and_mesh(experiment, kw, error):
    """An unknown mode, and a data mesh of 2 in a run of one process (a
    mesh takes one process per rank: torchrun)."""
    exp, corpus, *_ = experiment
    with pytest.raises(error, match="mode|mesh_data"):
        recognize(exp, corpus["vocab"], manifest=corpus["test"], device="cpu", **kw)


def test_experiment_load_is_memoized(experiment):
    exp, corpus, *_ = experiment
    a = rec_mod._load_experiment_cached(exp, corpus["vocab"], "best", torch.device("cpu"))
    b = rec_mod._load_experiment_cached(exp, corpus["vocab"], "best", torch.device("cpu"))
    assert a[0] is b[0]


_IMPORT_ALL = """
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "optax", "orbax"):
    sys.modules[blocked] = None
import asr_chinese_e2e_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# the measuring scripts, which import the port and each other
sys.path.insert(0, "scripts")
scripts = ("bench_decode_torch", "bench_stream_torch", "profile_torch_decode",
           "sweep_postln_torch", "lr_ab_torch")
for script in scripts:
    importlib.import_module(script)
leaked = sorted(
    m for m in sys.modules
    if m == "asr_chinese_e2e_tpu" or m.startswith("asr_chinese_e2e_tpu.")
    or m in ("bench", "recognize", "main", "preprocess")
)
assert not leaked, leaked
print(" ".join(names + list(scripts)))
"""

# the training slice's modules, each of which must import without jax
TRAINING_MODULES = {
    "asr_chinese_e2e_tpu_torch." + m for m in (
        "ops.ctc", "ops.ctc_kernel", "losses", "main", "core.registry",
        "data.batching", "data.native", "train.optimizer", "train.train_step",
        "train.metrics", "train.checkpoint", "train.trainer",
    )
}


# the joint / rescore decoding slice's modules
DECODE_MODULES = {
    "asr_chinese_e2e_tpu_torch." + m for m in (
        "decode.joint", "decode.ctc_prefix", "decode.ctc_prefix_device",
        "ops.ctc_prefix_kernel", "ops.ctc_prefix_beam_kernel", "recognize",
    )
}


# the parallelism slice's modules
PARALLEL_MODULES = {
    "asr_chinese_e2e_tpu_torch." + m for m in (
        "parallel.sharding", "parallel.context", "parallel.collectives",
        "parallel.dryrun", "decode.distributed", "ops.ring_attention",
    )
}


# the measuring programs (the JAX package's bench.py and its decode and
# stream benches, decode profile, post-LN sweep and LR A/B)
BENCH_MODULES = {"asr_chinese_e2e_tpu_torch.bench"} | {
    "bench_decode_torch", "bench_stream_torch", "profile_torch_decode", "sweep_postln_torch",
    "lr_ab_torch",
}


def test_port_imports_with_jax_blocked():
    """The test environment may import jax before a test starts, so the
    subprocess blocks the import rather than checking jax is absent."""
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 37
    assert TRAINING_MODULES <= names, TRAINING_MODULES - names
    assert DECODE_MODULES <= names, DECODE_MODULES - names
    assert PARALLEL_MODULES <= names, PARALLEL_MODULES - names
    assert BENCH_MODULES <= names, BENCH_MODULES - names


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


CARD_SCRIPTS = [
    REPO / "chip_smoke.py",
    REPO / "scripts" / "profile_torch_train.py",
    REPO / "scripts" / "profile_torch_attention.py",
    REPO / "scripts" / "profile_torch_kernels.py",
    REPO / "scripts" / "profile_k8_torch.py",
    REPO / "scripts" / "profile_k9_torch.py",
    REPO / "scripts" / "soak_flagship_torch.py",
    REPO / "scripts" / "soak_streaming_torch.py",
    REPO / "scripts" / "soak_ab_torch.py",
    REPO / "scripts" / "conformer_grad_gap_torch.py",
    REPO / "scripts" / "bf16_serving_gap_torch.py",
    REPO / "scripts" / "bench_decode_torch.py",
    REPO / "scripts" / "bench_stream_torch.py",
    REPO / "scripts" / "profile_torch_decode.py",
    REPO / "scripts" / "sweep_postln_torch.py",
    REPO / "scripts" / "lr_ab_torch.py",
    REPO / "scripts" / "sync_sites_torch.py",
]


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + CARD_SCRIPTS,
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_sources_import_no_jax(path):
    forbidden = {"jax", "flax", "optax", "orbax", "asr_chinese_e2e_tpu"}
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in forbidden]
    assert not bad, bad


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-CUDA exit")
@pytest.mark.parametrize("path", CARD_SCRIPTS, ids=lambda p: p.name)
def test_card_scripts_fail_without_cuda(path):
    proc = subprocess.run(
        [sys.executable, str(path)], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert '"ok"' not in proc.stdout


# -- host-module copies against their originals ------------------------------


def test_vocab_copy_matches_original(experiment):
    _, corpus, *_ = experiment
    ours, theirs = Vocab.load(corpus["vocab"]), JaxVocab.load(corpus["vocab"])
    assert ours.fingerprint() == theirs.fingerprint()
    assert ours.vocab_size == theirs.vocab_size
    text = "一丁七x"
    assert ours.str_to_ids(text, True, True) == theirs.str_to_ids(text, True, True)
    ids = list(range(ours.vocab_size))
    assert ours.ids_to_tokens(ids) == theirs.ids_to_tokens(ids)
    assert ours.ids_to_str(ids) == theirs.ids_to_str(ids)


def test_manifest_wav_and_corpus_copies_match_originals(experiment, tmp_path):
    _, corpus, *_ = experiment
    theirs = jax_make_synth_corpus(str(tmp_path / "jax_corpus"), **CORPUS_KW)
    assert Path(corpus["vocab"]).read_bytes() == Path(theirs["vocab"]).read_bytes()
    ours_recs, their_recs = read_manifest(corpus["test"]), jax_read_manifest(theirs["test"])
    assert len(ours_recs) == len(their_recs) == CORPUS_KW["n_test"]
    for a, b in zip(ours_recs, their_recs):
        assert (a["tgt"], a["frames"]) == (b["tgt"], b["frames"])
        for dtype in (np.int16, np.float32):
            np.testing.assert_array_equal(
                load_wav(a["wave"], dtype=dtype), jax_load_wav(b["wave"], dtype=dtype)
            )


def test_cer_cli_and_config_copies_match_originals(tmp_path):
    hyps, refs = ["今天天气", "你好", ""], ["今天天气好", "您好", "空"]
    assert corpus_cer(hyps, refs) == jax_corpus_cer(hyps, refs)
    argv = ["pos", "--a", "3", "--b=0.5", "--flag", "--lst", "[1, 2]", "--s", "x"]
    assert parse_kwargs(argv) == jax_parse_kwargs(argv)
    c = Config(a=1, b="x")
    c.combine({"b": "y"}).build(c=[1, 2])
    c.save(str(tmp_path / "c.json"))
    assert JaxConfig.load(str(tmp_path / "c.json")).to_dict() == c.to_dict()
    assert os.path.getsize(tmp_path / "c.json") > 0


def test_extract_copy_matches_original(tmp_path):
    from asr_chinese_e2e_tpu.data.extract import extract_aishell1 as jax_extract_aishell1
    from asr_chinese_e2e_tpu_torch.data.extract import extract_aishell1
    from tests.test_extract import _make_fixture

    outer = _make_fixture(tmp_path)
    roots = [fn(str(outer), str(tmp_path / name)) for fn, name in (
        (extract_aishell1, "ours"), (jax_extract_aishell1, "theirs"))]

    def tree(root):
        return {os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
                for d, _, files in os.walk(root) for f in files}

    assert tree(roots[0]) == tree(roots[1]) and len(tree(roots[0])) == 5
