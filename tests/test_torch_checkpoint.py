"""The port's ``CheckpointManager`` pointers: ``latest_name``, ``best_name``
and ``wait`` (the counterparts of ``tests/test_checkpoint.py``'s best
pointer and async-commit tests), and the pointers against the JAX
package's manager fed the same saves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_chinese_e2e_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from asr_chinese_e2e_tpu.train.train_step import TrainState as JaxTrainState
from asr_chinese_e2e_tpu_torch.train.checkpoint import CheckpointManager
from asr_chinese_e2e_tpu_torch.train.optimizer import Optimizer, default_train_config
from asr_chinese_e2e_tpu_torch.train.train_step import TrainState

torch.set_num_threads(2)


def _state(seed=0):
    model = torch.nn.Linear(3, 2)
    torch.nn.init.normal_(model.weight, generator=torch.Generator().manual_seed(seed))
    opt = Optimizer(model.parameters(), default_train_config(), 2)
    return TrainState(model=model, optimizer=opt, step=0, metric_sums={})


def _step(state):
    """One optimizer step on a fixed loss: the weights move."""
    loss = state.model(torch.ones(4, 3)).square().sum()
    state.optimizer.zero_grad()
    loss.backward()
    state.optimizer.step()
    state.step += 1


def test_best_pointer_lower_is_better(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), reference="-loss")
    state = _state()
    _step(state)
    mgr.save(state, epoch=0, metric=5.0)
    first = mgr.latest_name
    _step(state)
    mgr.save(state, epoch=0, metric=3.0)  # better
    second = mgr.latest_name
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    _step(state)
    mgr.save(state, epoch=1, metric=4.0)  # worse
    assert (first, second) == ("e0_s1", "e0_s2")
    assert mgr.best_name == second
    assert mgr.latest_name == "e1_s3" != second
    restored = _state(seed=1)
    meta = mgr.restore("best", restored)
    assert restored.step == 2
    assert meta["metric"] == 3.0
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_wait_returns_with_the_save_published(tmp_path):
    """Saves are synchronous: ``wait`` has nothing to drain, the pointers
    move as ``save`` returns, and a fresh manager (a restart) reads them."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert (mgr.latest_name, mgr.best_name) == (None, None)
    state = _state()
    _step(state)
    mgr.save(state, epoch=0)
    assert mgr.wait() is None
    assert mgr.latest_name == "e0_s1"
    assert mgr.best_name is None  # no metric given
    fresh = CheckpointManager(str(tmp_path / "ckpt"))
    assert fresh.latest_name == "e0_s1"
    restored = _state(seed=1)
    mgr.restore("latest", restored)
    assert restored.step == 1


# (epoch, metric) of each save
SAVES = [(0, 5.0), (0, None), (0, 3.0), (1, 4.0), (1, 2.5), (2, 2.5), (2, 9.0)]


@pytest.mark.parametrize("reference", ["-loss", "acc"])
def test_pointers_follow_jax(tmp_path, reference):
    """The same saves through JAX's manager (orbax, async, read after
    ``wait``) and the port's: the same latest and best after each."""
    jax_mgr = JaxCheckpointManager(str(tmp_path / "jax"), reference=reference,
                                   max_to_keep=3)
    mgr = CheckpointManager(str(tmp_path / "port"), reference=reference, max_to_keep=3)
    state = _state()
    got, want = [], []
    for step, (epoch, metric) in enumerate(SAVES, start=1):
        jax_state = JaxTrainState(params={"w": jnp.full((2,), float(step))}, opt_state={},
                                  step=jnp.asarray(step, jnp.int32), metric_sums={})
        jax_mgr.save(jax_state, epoch=epoch, metric=metric)
        jax_mgr.wait()
        want.append((jax_mgr.latest_name, jax_mgr.best_name))
        state.step = step
        mgr.save(state, epoch=epoch, metric=metric)
        mgr.wait()
        got.append((mgr.latest_name, mgr.best_name))
    assert got == want
    assert len({b for _, b in got}) >= 2  # the best pointer moved
    np.testing.assert_array_equal(sorted(mgr._index["all"]), sorted(jax_mgr._index["all"]))
