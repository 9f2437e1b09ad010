"""Two real processes training the port together, as the JAX package's
``tests/test_multiprocess.py`` (with ``tests/_mp_worker.py``) does: a
BiLSTMCTC ``Trainer`` over a data mesh of two gloo processes on the CPU,
each reading its own shard of the manifest (``num_hosts`` 2), two epochs,
then both resumed from the last checkpoint for a third
(``tests/torch_parallel_cases.py::multiprocess_case``). Checked: disjoint
shards that cover the manifest, equal batch counts (lockstep), one writer
of ``index.json``, ``meta.json`` and ``scalars.jsonl``, a resume at the
saved step, and the same weights on both processes after it. Then
tensor parallelism through ``main.train`` (a (data 1, model 2) mesh):
its checkpoints hold whole tensors (they load into an unsharded model)
and a resume cuts them back into each rank's chunks, Adam's moments too.
"""

import json
import os
from collections import Counter

import pytest
import torch

from asr_chinese_e2e_tpu_torch.parallel import dryrun
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus
from tests import torch_parallel_cases as cases


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    paths = make_synth_corpus(
        str(tmp / "corpus"), n_train=32, n_dev=4, n_test=4, n_tone_chars=8, vocab_size=40,
        seconds_range=(1.0, 1.4), tone_sec=0.25, seed=3)
    payload = {"manifest": paths["train"], "vocab": paths["vocab"],
               "exp_root": str(tmp / "exp")}
    r0, r1 = dryrun.run_ranks(2, cases.multiprocess_case, payload)
    return paths, r0, r1


def test_both_processes_step_in_lockstep(run):
    _, r0, r1 = run
    assert (r0["pid"], r1["pid"]) == (0, 1)
    assert r0["n_batches"] == r1["n_batches"] > 0
    assert r0["step_after_train"] == r1["step_after_train"] == 2 * r0["n_batches"]


def test_shards_are_disjoint_and_cover_the_manifest(run):
    """32 records in global batches of 2 x 4: nothing dropped, nothing
    read twice."""
    paths, r0, r1 = run
    with open(paths["train"]) as f:
        manifest = Counter(json.loads(line)["tgt"] for line in f)
    assert Counter(r0["shard"]) + Counter(r1["shard"]) == manifest
    assert not set(r0["shard"]) & set(r1["shard"])


def test_one_writer_of_the_shared_files(run):
    _, r0, r1 = run
    exp_dir = r0["exp_dir"]
    assert exp_dir == r1["exp_dir"]
    ckpt = os.path.join(exp_dir, "checkpoints")
    with open(os.path.join(ckpt, "index.json")) as f:
        idx = json.load(f)
    assert idx["latest"] is not None
    for name in idx["all"]:
        assert os.path.isfile(os.path.join(ckpt, name, "meta.json"))
        assert os.path.isfile(os.path.join(ckpt, name, "state.pt"))
    with open(os.path.join(exp_dir, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    seen = Counter((r["step"], tuple(sorted(k for k in r if k not in ("step", "time"))))
                   for r in rows)
    assert rows and not {k: c for k, c in seen.items() if c > 1}, "two writers"


def test_resume_continues_at_the_saved_step(run):
    _, r0, r1 = run
    per_epoch = r0["n_batches"]
    assert r0["step_after_resume"] == r1["step_after_resume"] == 3 * per_epoch
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name


# -- tensor parallelism through main.train: whole-tensor checkpoints ------------


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    paths = make_synth_corpus(
        str(tmp / "corpus"), n_train=8, n_dev=4, n_test=0, n_tone_chars=6, vocab_size=30,
        seconds_range=(0.6, 0.8), tone_sec=0.2, seed=6)
    kwargs = dict(
        vocab_path=paths["vocab"], train_manifest=paths["train"], dev_manifest=paths["dev"],
        test_manifest="", device="cpu", use_native_io=False, n_mels=20, d_model=32,
        num_heads=2, head_dim=16, d_ff=64, num_encoder_layers=1, num_decoder_layers=1,
        batch_size=4, log_every_iter=1, eval_every_iter=0, save_every_iter=0,
        lr_schedule="constant", lr=1e-3, dropout_rate=0.0, max_target_len=8,
        exp_root=str(tmp / "exp"), exp_name="tp", mesh_data=1, mesh_model=2)
    return paths, dryrun.run_ranks(2, cases.tp_trainer_case, {"kwargs": kwargs})


def test_tp_trainer_resumes_at_the_saved_step(tp_run):
    _, ranks = tp_run
    for rank in ranks:
        assert rank["steps"] == (2, 4)
        assert rank["n_split"] > 0
        assert rank["roundtrip"] and rank["moments_roundtrip"]


def test_tp_checkpoint_holds_whole_tensors(tp_run):
    """A model split over ``model`` saves whole tensors: the checkpoint and
    the exported best weights load into an unsharded model."""
    from asr_chinese_e2e_tpu_torch.utils.experiment import load_experiment

    paths, ranks = tp_run
    exp = ranks[0]["exp_dir"]
    model, *_ = load_experiment(exp, paths["vocab"], "best", device="cpu")
    with open(os.path.join(exp, "checkpoints", "index.json")) as f:
        latest = json.load(f)["latest"]
    blob = torch.load(os.path.join(exp, "checkpoints", latest, "state.pt"), weights_only=True)
    assert blob["model"].keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert blob["model"][k].shape == v.shape, k


# -- the bootstrap -----------------------------------------------------------------

_BOOT = """
import sys
from asr_chinese_e2e_tpu_torch.parallel.sharding import initialize_distributed, make_mesh
args = sys.argv[1:]
world, rank = (initialize_distributed(args[0], 2, int(args[1]), backend="gloo") if args
               else initialize_distributed(backend="gloo"))
mesh = make_mesh(data=-1)
print(world, rank, mesh.shape["data"], mesh.index("data"))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["address", "torchrun-environment"])
def test_initialize_distributed_joins_two_processes(how):
    """By ``coordinator_address`` / ``num_processes`` / ``process_id``, or by
    ``torchrun``'s environment: (world size, rank), and a data mesh over
    both."""
    import subprocess
    import sys

    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        args = [f"127.0.0.1:{port}", str(rank)]
        if how != "address":
            env.update(WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            args = []
        procs.append(subprocess.Popen([sys.executable, "-c", _BOOT, *args], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ["2", str(rank), "2", str(rank)]


def test_initialize_distributed_is_a_no_op_for_one_process(monkeypatch):
    from asr_chinese_e2e_tpu_torch.parallel.sharding import initialize_distributed

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() == (1, 0)
    assert initialize_distributed("127.0.0.1:1", 1, 0) == (1, 0)
    assert not torch.distributed.is_initialized()
