"""Multi-process dry run on the CPU (``__graft_entry__.py::
dryrun_multichip`` of the JAX package), and the process launcher it and
the multi-process tests share.

``dryrun_multichip(n)`` spawns ``n`` gloo ranks on the CPU and runs one
training step of a tiny flagship-shaped model (fbank, hybrid CTC/CE
loss, gradients, Noam + Adam) on each of:

- a DP x TP mesh: the batch over ``data``, the model split over ``model``
  (2 when n >= 4 and even, else 1), the fused attention's path;
- when n % 8 == 0, DP x TP x SP: ``attn_impl="ring"`` over ``seq`` = 2.

    python -m asr_chinese_e2e_tpu_torch.parallel.dryrun 8
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, n: int, store: str, out_dir: str, fn, args, backend: str) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}", world_size=n, rank=rank)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(n: int, fn, *args, backend: str = "gloo") -> list:
    """Run ``fn(*args)`` in ``n`` spawned processes that form a process
    group (one torch thread each): gloo on the CPU, or with ``backend=
    "nccl"`` rank r on card r; returns each rank's result, in rank order.
    ``fn`` must be importable by name (a module-level function). A rank
    that raises fails the call with its traceback."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        mp.start_processes(_rank_main, args=(n, store, tmp, fn, args, backend), nprocs=n,
                           join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def _dryrun_step(data: int, model_axis: int, seq: int, attn_impl: str) -> dict:
    """One training step on a (data, model, seq) mesh of this process
    group; returns {"mesh": ..., "loss": ..., "split": parameters split
    over ``model``}."""
    from ..data.features import FeatureConfig
    from ..models.transformer import SpeechTransformer, default_config
    from ..train.optimizer import default_train_config, make_optimizer
    from ..train.train_step import make_step_fns
    from .context import active_mesh
    from .sharding import make_mesh, shard_batch, shard_model_

    mesh = make_mesh(data=data, model=model_axis, seq=seq)
    feat_cfg = FeatureConfig(n_mels=20)
    vocab_size = 64
    cfg = default_config().build(
        ctc_weight=0.3, d_model=64, num_heads=4, head_dim=16, d_ff=128,
        num_encoder_layers=2, num_decoder_layers=2, input_dim=feat_cfg.feature_dim,
        attn_impl=attn_impl,
    )
    tcfg = default_train_config().combine(cfg).build(spec_augment=True)
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0))
    split = shard_model_(model, mesh)
    optimizer = make_optimizer(model.parameters(), tcfg, cfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, optimizer, feat_cfg, tcfg)
    rng = np.random.RandomState(0)
    bsz, samples, l = 2 * mesh.shape["data"], 8000, 6
    batch = [
        np.asarray(rng.randn(bsz, samples), np.float32),
        np.full((bsz,), samples, np.int32),
        rng.randint(4, vocab_size, size=(bsz, l)).astype(np.int32),
        np.full((bsz,), l, np.int32),
    ]
    with active_mesh(mesh):
        state = init_fn()
        _, metrics = train_step(state, *map(torch.from_numpy, shard_batch(mesh, batch)), 1)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    return {"mesh": dict(mesh.shape), "loss": loss, "split": sorted(split)}


def _dryrun_ranks(n: int) -> list:
    model_axis = 2 if n % 2 == 0 and n >= 4 else 1
    out = [_dryrun_step(-1, model_axis, 1, "fused")]
    if n % 8 == 0:
        out.append(_dryrun_step(n // 4, 2, 2, "ring"))
    return out


def dryrun_multichip(n: int) -> list:
    """Sharded training steps on meshes of ``n`` CPU ranks (tiny shapes);
    prints and returns rank 0's results (one per mesh)."""
    results = run_ranks(n, _dryrun_ranks, n)[0]
    for r in results:
        print(f"dryrun_multichip({n}): mesh={r['mesh']} loss={r['loss']:.4f} "
              f"split={len(r['split'])} parameters")
    return results


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
