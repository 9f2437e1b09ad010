"""The port's soak scripts on the CPU with a tiny model.

``scripts/soak_flagship_torch.py``'s phase functions run a real SIGKILL at
the first cadence checkpoint, a resume whose first logged step follows the
saved one at ``current_lr`` there, and both decodes; a kill while
``CheckpointManager.save`` retires old checkpoints leaves no published
pointer to a deleted one; the soak's model starts from flax's initial
statistics."""

import importlib.util
import json
import os
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# the tiny model and the CPU: the rest of each command is the soak recipe
TINY = {
    "d_model": 32, "num_heads": 4, "head_dim": 8, "d_ff": 64,
    "num_encoder_layers": 1, "num_decoder_layers": 1, "n_mels": 20,
    "dtype": "float32", "batch_size": 4, "num_epoch": 3, "log_every_iter": 1,
    "save_every_iter": 1, "eval_every_iter": 0, "max_target_len": 16,
    "device": "cpu", "use_native_io": "false",
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    soak = _load("soak_flagship_torch")
    root = tmp_path_factory.mktemp("soak")
    paths = soak.gen_corpus(str(root / "corpus"), n_train=24, n_eval=4,
                            seconds_range=(0.6, 1.5))
    return soak, root, paths


def test_flagship_soak_kill_resume_decode(corpus):
    soak, root, paths = corpus
    exp_root = str(root / "exp")
    exp_dir = os.path.join(exp_root, soak.EXP_NAME)
    kill = soak.run_until_killed(
        soak.train_cmd(paths, exp_root, TINY), exp_dir, kill_step=2,
        log_path=str(root / "phase1.log"),
    )
    assert kill["step"] >= 2
    # the kill landed mid-run: the last epoch's checkpoint is not there
    index = json.load(open(os.path.join(exp_dir, "checkpoints", "index.json")))
    assert all(not name.startswith("e3_") for name in index["all"])
    soak.run_to_completion(
        soak.train_cmd(paths, exp_root, {**TINY, "from_ckpt": "latest"}),
        str(root / "phase2.log"),
    )
    summary = soak.summarize(exp_dir, kill)
    resume = summary["resume"]
    assert resume["first_logged_step_after_resume"] == kill["step"] + 1
    assert resume["optimizer_count"] == kill["step"]
    assert resume["first_lr_after_resume"] == resume["current_lr_there"]
    assert summary["checkpoints"]["latest"].startswith("e3_")
    for mode in ("joint", "beam"):
        out = str(root / f"decode_{mode}.json")
        cer = soak.decode(paths, exp_dir, mode, out,
                          {"device": "cpu", "max_decode_len": 8})
        result = json.load(open(out))
        assert len(result["utts"]) == 4 and cer == result["cer"]


def test_a_kill_while_retiring_a_checkpoint_leaves_no_dangling_pointer(tmp_path, monkeypatch):
    """``CheckpointManager.save`` publishes the index before it deletes the
    checkpoints past ``max_to_keep``: a process killed right after the
    first deletion leaves an index whose every name is on disk."""
    import torch

    from asr_chinese_e2e_tpu_torch.train import checkpoint as ckpt_mod
    from asr_chinese_e2e_tpu_torch.train.checkpoint import CheckpointManager
    from asr_chinese_e2e_tpu_torch.train.optimizer import Optimizer, default_train_config

    class Killed(BaseException):
        pass

    model = torch.nn.Linear(2, 2)
    state = type("State", (), {})()
    state.model, state.step, state.metric_sums = model, 0, {}
    state.optimizer = Optimizer(model.parameters(), default_train_config(), 2)
    manager = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step, metric in ((1, 3.0), (2, 2.0)):
        state.step = step
        manager.save(state, 0, metric=metric)
    real_rmtree = ckpt_mod.shutil.rmtree

    def killed_after_deleting(path, **kw):
        real_rmtree(path, **kw)
        raise Killed()

    monkeypatch.setattr(ckpt_mod.shutil, "rmtree", killed_after_deleting)
    state.step = 3
    with pytest.raises(Killed):
        manager.save(state, 0, metric=1.0)  # the new best retires e0_s1
    index = json.load(open(tmp_path / "index.json"))
    assert index["latest"] == index["best"] == "e0_s3"
    for name in index["all"]:
        assert (tmp_path / name / "state.pt").is_file(), name


def test_flagship_init_statistics_match_flax():
    """The soak's model (the flagship, pre-LN) from ``torch.Generator``
    seed 0 has flax's initial statistics: every tensor's standard deviation
    within 5 % and its mean within 0.05 of the flax init's (PRNGKey 0),
    so a run's start differs from the JAX soak's by the draw alone."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from asr_chinese_e2e_tpu.models.transformer import SpeechTransformer as JaxModel
    from asr_chinese_e2e_tpu.models.transformer import default_config
    from asr_chinese_e2e_tpu_torch.core.config import Config
    from asr_chinese_e2e_tpu_torch.models.convert import torch_state_from_flax
    from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer

    vocab = 4233
    jcfg = default_config().build(norm_type="pre", dropout_rate=0.0, ctc_weight=0.3,
                                  input_dim=320)
    params = JaxModel(jcfg, vocab).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 320)), jnp.asarray([8]),
        jnp.zeros((1, 3), jnp.int32), jnp.asarray([2]))
    cfg = Config(**jcfg.to_dict())
    want = torch_state_from_flax(jax.tree.map(np.asarray, params), cfg, vocab)
    got = SpeechTransformer(cfg, vocab, torch.Generator().manual_seed(0)).state_dict()
    assert got.keys() == want.keys() and len(got) > 250
    for key, x in got.items():
        a, b = x.float(), want[key].float()
        assert abs(float(a.mean() - b.mean())) < 0.05, key
        if a.numel() > 1:
            assert float(a.std()) == pytest.approx(float(b.std()), rel=0.05, abs=1e-6), key
