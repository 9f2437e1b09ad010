r"""Training CLI of the port (the root ``main.py`` of the JAX package):

    python -m asr_chinese_e2e_tpu_torch.main train --model_name TransformerOffical \
        --lr 3e-4 --batch_size 64 --warm_up 4000 --num_epoch 200 --device cuda

(``key=value`` words after ``train`` work as well as ``--key value``.)

Three-stage config merge (data/train defaults -> model defaults -> CLI
kwargs, CLI wins, unknown keys added), the model chosen by name from the
registry, then the trainer on one device. ``--from_ckpt
latest|best|e{E}_s{S}`` resumes. ``--device`` is ``cuda`` (the kernels) or
``cpu`` (their plain versions); the weights are made from
``torch.Generator`` seeded with ``--seed``.
"""

from __future__ import annotations

import os
import sys

import torch

from .core.config import Config, resolve_config
from .core.registry import get_model
from .data.batching import BucketedLoader
from .data.vocab import Vocab
from .train.optimizer import default_train_config, make_optimizer, model_width
from .train.trainer import Trainer
from .utils.cli import coerce, parse_kwargs
from .utils.experiment import feature_config_from


def data_config() -> Config:
    """Data-tier defaults (the root ``main.py::data_config`` of the JAX
    package, without its mesh and multi-host keys)."""
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
    )


def train(**cli_kwargs) -> Trainer:
    """Build the run from ``cli_kwargs`` (the root ``main.py::train``
    kwargs), train it, and return the trainer."""
    if "warm_up" in cli_kwargs:
        cli_kwargs.setdefault("warmup", cli_kwargs.pop("warm_up"))
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
                # eval splits keep their tails (a small dev set may fill no
                # bucket to batch_size)
                drop_last=(split == "train"),
            )

    device = torch.device(cfg.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available")
    generator = torch.Generator().manual_seed(int(cfg.seed))
    model = model_cls(cfg, vocab.vocab_size, generator).to(device)
    optimizer = make_optimizer(model.parameters(), cfg, model_width(cfg))
    trainer = Trainer(
        model, optimizer, cfg, feat_cfg, vocab,
        train_loader=loaders["train"],
        dev_loader=loaders.get("dev"),
        test_loader=loaders.get("test"),
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
