"""Per-rank bodies of the multi-process tests of the port's parallelism
(``tests/test_torch_parallel.py``, ``test_torch_ring_attention.py``,
``test_torch_distributed_decode.py``, ``test_torch_multiprocess.py``).

Each function runs in every process of a gloo group that
``asr_chinese_e2e_tpu_torch/parallel/dryrun.py::run_ranks`` spawns on the
CPU, and returns what the test compares in the parent. Nothing here
imports jax: the parent computes the JAX side.
"""

from __future__ import annotations

import torch

from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.models import layers
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer
from asr_chinese_e2e_tpu_torch.parallel import sharding
from asr_chinese_e2e_tpu_torch.parallel.context import active_mesh
from asr_chinese_e2e_tpu_torch.train.optimizer import default_train_config, make_optimizer
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns

ARGS = ("wave", "wave_lengths", "labels", "label_lengths")


def _model(cfg: dict, state: dict, vocab: int):
    pcfg = Config(**cfg)
    model = SpeechTransformer(pcfg, vocab)
    model.load_state_dict(state)
    return pcfg, model


def _steps(pcfg, model, batch, n_steps, mesh, train_overrides=None):
    """``n_steps`` train steps on raw features of this rank's rows of
    ``batch`` under ``mesh``; returns (losses, norms, optimizer, state)."""
    tcfg = default_train_config().combine(pcfg).build(**(train_overrides or {}))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the tiny model's Noam peak
        opt = make_optimizer(model.parameters(), tcfg, pcfg.d_model)
    if mesh is not None and mesh.shape["model"] > 1:
        opt.set_tensor_parallel(mesh.group("model"), sharding.sharded_parameters(model))
    init_fn, train_step, _ = make_step_fns(model, opt, FeatureConfig(), tcfg, raw_features=True)
    rows = sharding.shard_batch(mesh, [torch.from_numpy(batch[k]) for k in ARGS])
    losses, norms = [], []
    with active_mesh(mesh):
        state = init_fn()
        for _ in range(n_steps):
            state, m = train_step(state, *rows, 0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, opt, state


def train_cases(payload: dict) -> dict:
    """Data-parallel steps (data 2, hash dropout with every seed pinned to
    ``payload["seed"]``), then tensor-parallel steps (model 2, dropout 0),
    ``payload["steps"]`` of each with the train config's ``payload["train"]``:
    losses, gradient norms, the weights after, and the shapes of the split
    parameters and of their Adam moments."""
    out = {}
    seed = payload["seed"]
    layers.draw_seed = lambda rng: seed
    mesh = sharding.make_mesh(data=2)
    pcfg, model = _model(payload["dp_cfg"], payload["dp_state"], payload["vocab"])
    losses, norms, _, _ = _steps(pcfg, model, payload["dp_batch"], payload["steps"], mesh,
                                 payload["train"])
    out["dp"] = {"losses": losses, "norms": norms, "state": model.state_dict()}

    mesh = sharding.make_mesh(data=1, model=2)
    pcfg, model = _model(payload["tp_cfg"], payload["tp_state"], payload["vocab"])
    whole = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    split = sharding.shard_model_(model, mesh)
    losses, norms, opt, _ = _steps(pcfg, model, payload["tp_batch"], payload["steps"], mesh,
                                   payload["train"])
    names = {id(p): n for n, p in model.named_parameters()}
    moments = {names[id(p)]: {k: tuple(v.shape) for k, v in opt.adam.state[p].items()
                              if k in ("exp_avg", "exp_avg_sq")} for p in opt.params}
    out["tp"] = {
        "losses": losses, "norms": norms, "split": split, "whole": whole,
        "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
        "moments": moments,
        "state": sharding.gather_state(model, model.state_dict()),
    }
    return out


def sharded_attention_cases(payload: dict) -> dict:
    """``fused_attention_sharded_general`` on a (data 2, model 2) mesh: this
    rank's rows and heads of each case's inputs; returns its outputs and
    the gradients of sum(out * g), per case, and under "square" the same
    of the square entry point ``fused_attention_sharded``."""
    from asr_chinese_e2e_tpu_torch.ops.fused_attention import (
        fused_attention_sharded,
        fused_attention_sharded_general,
    )

    mesh = sharding.make_mesh(data=2, model=2)
    d, m = mesh.index("data"), mesh.index("model")
    out = {}
    for name, case in payload.items():
        bsz, heads = case["q"].shape[:2]
        rows = slice(d * bsz // 2, (d + 1) * bsz // 2)
        split = case["heads_split"]
        cols = slice(m * heads // 2, (m + 1) * heads // 2) if split else slice(0, heads)
        lens = torch.from_numpy(case["lengths"][rows])
        args = (case["seed"], case["scale"], case["rate"])

        def run(call):
            qkv = [torch.from_numpy(case[k][rows, cols]).requires_grad_(True) for k in "qkv"]
            o = call(*qkv)
            (o * torch.from_numpy(case["g"][rows, cols])).sum().backward()
            return {"out": o.detach(), "grads": [t.grad for t in qkv]}

        out[name] = {
            **run(lambda *qkv: fused_attention_sharded_general(
                mesh, *qkv, lens, lens, *args, False, heads_split=split)),
            "square": run(lambda *qkv: fused_attention_sharded(
                mesh, *qkv, lens, *args, heads_split=split)),
            "rows": rows, "cols": cols,
        }
    return out


def ring_cases(payload: dict) -> dict:
    """Ring attention over ``seq`` (meshes (data 1, seq 4) and (data 2, seq
    2)): each case's block of the output and of the gradients of sum(out *
    g) on this rank, the ``attn_impl="ring"`` encoder on the (data 2, seq 2)
    mesh, and a train step through it."""
    from asr_chinese_e2e_tpu_torch.ops.ring_attention import ring_attention

    out = {}
    for seq in (4, 2):
        mesh = sharding.make_mesh(data=4 // seq, seq=seq)
        group, r = mesh.group("seq"), mesh.index("seq")
        for name, case in payload["cases"].items():
            t = case["q"].shape[1]
            blk = slice(r * t // seq, (r + 1) * t // seq)
            qkv = [torch.from_numpy(case[k][:, blk]).requires_grad_(True) for k in "qkv"]
            o = ring_attention(*qkv, torch.from_numpy(case["valid"]), group)
            (o * torch.from_numpy(case["g"][:, blk])).sum().backward()
            out[seq, name] = {"block": blk, "out": o.detach(),
                              "grads": [x.grad for x in qkv]}
    mesh = sharding.make_mesh(data=2, seq=2)
    pcfg, model = _model(payload["cfg"], payload["state"], payload["vocab"])
    feats, lens = (torch.from_numpy(payload[k]) for k in ("feats", "feat_lens"))
    rows = sharding.batch_rows(mesh, feats.shape[0])
    with active_mesh(mesh), torch.no_grad():
        enc, enc_lens = model.eval().encode(feats[rows], lens[rows])
    out["encode"] = {"rows": rows, "enc": enc, "lens": enc_lens}
    losses, norms, _, _ = _steps(pcfg, model.train(), payload["batch"], 2, mesh,
                                 payload["train"])
    out["steps"] = {"losses": losses, "norms": norms, "state": model.state_dict()}
    return out


def decode_cases(payload: dict) -> dict:
    """``distributed_beam_search`` on a data mesh of 2 (a divisible batch,
    one that does not divide, and rows already split), ``exchange_scores``,
    ``distributed_rescore_scores`` and ``make_sharded_rescorer``."""
    from asr_chinese_e2e_tpu_torch.decode.distributed import (
        distributed_beam_search,
        distributed_rescore_scores,
        exchange_scores,
        make_sharded_rescorer,
    )

    mesh = sharding.make_mesh(data=2)
    group = mesh.group("data")
    pcfg, model = _model(payload["cfg"], payload["state"], payload["vocab"])
    model.eval()
    out = {}
    with torch.no_grad():
        for name, (enc, lens) in payload["enc"].items():
            enc, lens = torch.from_numpy(enc), torch.from_numpy(lens)
            res = distributed_beam_search(model, enc, lens, payload["beam"], payload["max_len"],
                                          mesh)
            out[name] = res.materialize()
        enc, lens = (torch.from_numpy(x) for x in payload["enc"]["divisible"])
        rows = sharding.batch_rows(mesh, enc.shape[0])
        out["local_rows"] = distributed_beam_search(
            model, enc[rows], lens[rows], payload["beam"], payload["max_len"], mesh,
            local_rows=True).materialize()
    scores = torch.from_numpy(payload["scores"])
    ctc, att = (torch.from_numpy(payload[k]) for k in ("ctc", "att"))
    rows = sharding.batch_rows(mesh, scores.shape[0])
    out["exchange"] = exchange_scores(scores[rows], group)
    out["rescore"] = distributed_rescore_scores(ctc[rows], att[rows], payload["lam"], group)
    out["rescorer"] = make_sharded_rescorer(mesh)(ctc, att, payload["lam"])
    return out


def trainer_case(payload: dict) -> dict:
    """``main.train`` under a data mesh of 2 (``num_processes`` 2 from the
    group this process is in) with ``eval_decode="beam"``: the dev rows of
    ``scalars.jsonl``, read back by every rank."""
    import json
    import os

    from asr_chinese_e2e_tpu_torch.main import train

    trainer = train(**payload["kwargs"])
    path = os.path.join(trainer.exp_dir, "scalars.jsonl")
    torch.distributed.barrier()
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {"rows": rows, "mesh": dict(trainer.mesh.shape),
            "n_chips": trainer.throughput.n_chips}


def multiprocess_case(payload: dict) -> dict:
    """The JAX package's two-process run (``tests/_mp_worker.py``): a
    BiLSTMCTC ``Trainer`` over a data mesh of the two processes, each
    reading its shard of the manifest (``num_hosts`` 2), two epochs, then
    a resume of both processes from the last checkpoint for a third."""
    from asr_chinese_e2e_tpu_torch.data.batching import BucketedLoader
    from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
    from asr_chinese_e2e_tpu_torch.models.rnn import BiLSTMCTC, default_ctc_config
    from asr_chinese_e2e_tpu_torch.train.trainer import Trainer

    world, pid = torch.distributed.get_world_size(), torch.distributed.get_rank()
    vocab = Vocab.load(payload["vocab"])
    feat_cfg = FeatureConfig(n_mels=20)

    def make_loader():
        return BucketedLoader(
            payload["manifest"], vocab, batch_size=4, max_target_len=8, seed=0,
            bucket_seconds=(1.5,), prefetch=0, num_hosts=world, host_id=pid,
            use_native_io=False,
        )

    shard, n_batches = [], 0
    for b in make_loader().epoch(0):
        n_batches += 1
        shard.extend(b.texts)
    mesh = sharding.make_mesh(data=-1)
    mcfg = default_ctc_config().build(hidden_size=16, num_encoder_layers=1,
                                      input_dim=feat_cfg.feature_dim)
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="constant", lr=5e-3, batch_size=4, num_epoch=2, log_every_iter=2,
        eval_every_iter=10_000, save_every_iter=10_000, exp_root=payload["exp_root"],
        exp_name="mp", ctc_weight=1.0, ctc_impl="scan",
    )

    def trainer(cfg):
        model = BiLSTMCTC(mcfg, vocab.vocab_size, torch.Generator().manual_seed(0))
        opt = make_optimizer(model.parameters(), cfg, 16)
        return Trainer(model, opt, cfg, feat_cfg, vocab, make_loader(), mesh=mesh)

    first = trainer(tcfg)
    first.train()
    second = trainer(tcfg.build(num_epoch=3))
    second.train(from_ckpt="latest")
    return {"pid": pid, "shard": shard, "n_batches": n_batches,
            "step_after_train": first.state.step, "step_after_resume": second.state.step,
            "exp_dir": second.exp_dir,
            "params": {k: v.clone() for k, v in second.model.state_dict().items()}}


def tp_trainer_case(payload: dict) -> dict:
    """``main.train`` on a (data 1, model 2) mesh for one epoch, then
    resumed from its checkpoint for a second; the steps, the experiment,
    and whether gathering a split state and cutting it again gives this
    rank's chunks back (model and Adam moments)."""
    from asr_chinese_e2e_tpu_torch.main import train

    first = train(**payload["kwargs"], num_epoch=1)
    second = train(**payload["kwargs"], num_epoch=2, from_ckpt="latest")
    model, opt = second.model, second.optimizer
    local = model.state_dict()
    back = sharding.slice_state(model, sharding.gather_state(model, local))
    state = opt.state_dict()
    opt_back = sharding.slice_optimizer_state(
        model, opt, sharding.gather_optimizer_state(model, opt, state))
    moments_equal = all(
        torch.equal(a[k], opt_back["adam"]["state"][i][k])
        for i, a in state["adam"]["state"].items() for k in ("exp_avg", "exp_avg_sq"))
    return {"steps": (first.state.step, second.state.step), "exp_dir": second.exp_dir,
            "roundtrip": all(torch.equal(local[k], back[k]) for k in local),
            "moments_roundtrip": moments_equal,
            "n_split": len(sharding.sharded_parameters(model))}
