r"""Training CLI of the port (the root ``main.py`` of the JAX package):

    python -m asr_chinese_e2e_tpu_torch.main train --model_name TransformerOffical \
        --lr 3e-4 --batch_size 64 --warm_up 4000 --num_epoch 200 --device cuda

(``key=value`` words after ``train`` work as well as ``--key value``.)

Three-stage config merge (data/train defaults -> model defaults -> CLI
kwargs, CLI wins, unknown keys added), the model chosen by name from the
registry, then the trainer. ``--from_ckpt latest|best|e{E}_s{S}`` resumes.
``--device`` is ``cuda`` (the kernels) or ``cpu`` (their plain versions);
the weights are made from ``torch.Generator`` seeded with ``--seed``.

Across processes, one per device (the root ``main.py``'s multi-host keys):
under ``torchrun --nproc_per_node N -m asr_chinese_e2e_tpu_torch.main
train ...``, or with ``--num_processes N --coordinator_address host:port
--process_id i`` in each process, every process joins the group
(``parallel/sharding.py::initialize_distributed``; ``--dist_backend gloo``
serves several ranks on one card) and trains on ``cuda:{local rank}``
over a (``mesh_data``, ``mesh_model``, ``mesh_seq``) mesh: ``mesh_data``
-1 takes the ranks left, 0 turns the mesh off; a ``batch_size`` (the
global batch) that does not divide the data axis warns and runs unsharded.
``num_hosts`` / ``host_id`` shard the manifest, one shard per data rank
(``batch_size`` is then each shard's).
"""

from __future__ import annotations

import os
import sys

import torch

from .core.config import Config, resolve_config
from .core.registry import get_model
from .data.batching import BucketedLoader
from .data.vocab import Vocab
from .parallel.sharding import initialize_distributed, local_rank, make_mesh
from .train.optimizer import default_train_config, make_optimizer, model_width
from .train.trainer import Trainer
from .utils.cli import coerce, parse_kwargs
from .utils.experiment import feature_config_from


def data_config() -> Config:
    """Data-tier defaults (the root ``main.py::data_config`` of the JAX
    package)."""
    return Config(
        data_dir="data",
        vocab_path="data/vocab.json",
        train_manifest="data/train.jsonl",
        dev_manifest="data/dev.jsonl",
        test_manifest="data/test.jsonl",
        n_mels=80,
        lfr_m=4,
        lfr_n=3,
        sample_rate=16000,
        max_target_len=64,
        spec_augment=False,
        wire_dtype="int16",
        model_name="TransformerOffical",
        from_ckpt=None,
        device="cuda",
        use_native_io=True,
        mesh_data=-1,
        mesh_model=1,
        mesh_seq=1,  # sequence parallelism (with attn_impl="ring")
        num_hosts=1,
        host_id=0,
    )


def _bootstrap(cli_kwargs: dict) -> int:
    """Join the process group named by ``num_processes`` /
    ``coordinator_address`` / ``process_id`` (popped from the kwargs) or by
    ``torchrun``'s environment; returns the world size."""
    world, _ = initialize_distributed(
        cli_kwargs.pop("coordinator_address", None),
        cli_kwargs.pop("num_processes", None),
        cli_kwargs.pop("process_id", None),
        backend=cli_kwargs.pop("dist_backend", None)
        or ("gloo" if cli_kwargs.get("device", "cuda") == "cpu" else None),
    )
    return world


def _mesh_for(cfg, world: int):
    """The root ``main.py``'s mesh layout: none for one rank and no model
    or seq axis, or with ``mesh_data`` 0; ``mesh_data`` -1 takes the ranks
    left; a batch that does not divide the data axis runs unsharded."""
    model, seq = int(cfg.mesh_model), int(cfg.get("mesh_seq", 1))
    if cfg.mesh_data == 0 or (world == 1 and model == 1 and seq == 1):
        return None
    data = world // (model * seq) if cfg.mesh_data == -1 else int(cfg.mesh_data)
    if cfg.num_hosts == 1 and cfg.batch_size % max(data, 1):
        print(f"warning: batch_size {cfg.batch_size} not divisible by data axis; "
              "running unsharded")
        return None
    return make_mesh(data=cfg.mesh_data, model=model, seq=seq)


def train(**cli_kwargs) -> Trainer:
    """Build the run from ``cli_kwargs`` (the root ``main.py::train``
    kwargs), train it, and return the trainer."""
    if "warm_up" in cli_kwargs:
        cli_kwargs.setdefault("warmup", cli_kwargs.pop("warm_up"))
    device = torch.device(cli_kwargs.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available")
    # the process group first (before any device work)
    world = _bootstrap(cli_kwargs)
    base = data_config().combine(default_train_config())
    model_name = cli_kwargs.get("model_name", base.model_name)
    model_cls, model_default = get_model(model_name)
    cfg = resolve_config(base, model_default(), cli_kwargs)
    feat_cfg = feature_config_from(cfg)
    if "input_dim" not in cli_kwargs or model_cls.input_dim_from_features(cfg):
        cfg.build(input_dim=feat_cfg.feature_dim)

    vocab = Vocab.load(cfg.vocab_path)
    loaders = {}
    for split, manifest in (
        ("train", cfg.train_manifest),
        ("dev", cfg.dev_manifest),
        ("test", cfg.test_manifest),
    ):
        if manifest and os.path.exists(manifest):
            loaders[split] = BucketedLoader(
                manifest, vocab, batch_size=cfg.batch_size,
                max_target_len=cfg.max_target_len, sample_rate=cfg.sample_rate,
                shuffle=(split == "train"), seed=cfg.seed,
                use_native_io=cfg.get("use_native_io", True),
                wire_dtype=cfg.get("wire_dtype", "int16"),
                num_hosts=cfg.num_hosts, host_id=cfg.host_id,
                # eval splits keep their tails (a small dev set may fill no
                # bucket to batch_size)
                drop_last=(split == "train"),
            )

    if device.type == "cuda" and world > 1:
        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = _mesh_for(cfg, world)
    generator = torch.Generator().manual_seed(int(cfg.seed))
    model = model_cls(cfg, vocab.vocab_size, generator).to(device)
    optimizer = make_optimizer(model.parameters(), cfg, model_width(cfg))
    trainer = Trainer(
        model, optimizer, cfg, feat_cfg, vocab,
        train_loader=loaders["train"],
        dev_loader=loaders.get("dev"),
        test_loader=loaders.get("test"),
        mesh=mesh,
    )
    trainer.train(from_ckpt=cfg.from_ckpt)
    return trainer


def main() -> None:
    positional, kwargs = parse_kwargs(sys.argv[1:])
    if kwargs.pop("help", False) or positional[:1] != ["train"]:
        print(__doc__)
        return
    for word in positional[1:]:
        key, sep, value = word.partition("=")
        if not sep:
            raise SystemExit(f"unexpected argument {word!r}")
        kwargs[key] = coerce(value)
    train(**kwargs)


if __name__ == "__main__":
    main()
