"""Experiment loading for the port: ``config.json`` + the port's checkpoint
``torch_checkpoints/{which}.pt`` + vocab fingerprint check.

The JAX package's orbax checkpoints become the port's checkpoints through
``scripts/export_torch_checkpoint.py``. A port checkpoint is a
``torch.save`` dict ``{"state_dict", "vocab_fingerprint"}``.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..core.config import Config
from ..core.registry import get_model
from ..data.features import FeatureConfig
from ..data.vocab import Vocab
from ..models.transformer import SpeechTransformer

CKPT_DIR = "torch_checkpoints"


def feature_config_from(cfg: Config) -> FeatureConfig:
    """The ONE cfg->FeatureConfig mapping (training and decode must agree)."""
    return FeatureConfig(
        sample_rate=cfg.get("sample_rate", 16000),
        n_mels=cfg.get("n_mels", 80),
        lfr_m=cfg.get("lfr_m", 4),
        lfr_n=cfg.get("lfr_n", 3),
        feature_type=cfg.get("feature_type", "fbank"),
        n_mfcc=cfg.get("n_mfcc", 40),
        cmvn_mode=cfg.get("cmvn_mode", "global"),
        cmvn_mean=cfg.get("cmvn_mean", 0.0),
        cmvn_std=cfg.get("cmvn_std", 1.0),
        use_delta=cfg.get("use_delta", False),
        use_delta_delta=cfg.get("use_delta_delta", False),
        fbank_impl=cfg.get("fbank_impl", "xla"),
        freq_mask_param=cfg.get("freq_mask_param", 30),
        time_mask_param=cfg.get("time_mask_param", 40),
        num_freq_masks=cfg.get("num_freq_masks", 1),
        num_time_masks=cfg.get("num_time_masks", 1),
        num_time_warps=cfg.get("num_time_warps", 0),
        time_warp_param=cfg.get("time_warp_param", 5),
    )


def checkpoint_path(exp_dir: str, which: str) -> str:
    return os.path.join(exp_dir, CKPT_DIR, f"{which}.pt")


def save_torch_checkpoint(
    exp_dir: str, state_dict: dict, vocab_fingerprint: str, which: str = "latest"
) -> str:
    """Write ``torch_checkpoints/{which}.pt``; returns its path."""
    path = checkpoint_path(exp_dir, which)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "vocab_fingerprint": vocab_fingerprint,
    }
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    return path


def load_experiment(
    exp_dir: str, vocab_path: str, which: str = "best", device="cuda"
) -> Tuple[torch.nn.Module, Config, FeatureConfig, Vocab]:
    """Returns (the registry's model for ``model_name`` on ``device``, in
    eval mode, cfg, feat_cfg, vocab). A SpeechTransformer's weights are cast
    to its configured dtype; the RNN family keeps f32 weights (its LSTMs
    compute in f32, its dense layers cast at use). ``device`` is the card
    unless the caller asks for ``"cpu"`` (the plain versions); asking for
    the card without one raises. ``best`` falls back to ``latest`` when no
    best checkpoint exists, as the JAX loader does."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available")
    cfg = Config.load(os.path.join(exp_dir, "config.json"))
    vocab = Vocab.load(vocab_path)
    # the variant's hyperparameters are already merged into config.json
    model_cls, _ = get_model(cfg.get("model_name", "SpeechTransformer"))
    path = checkpoint_path(exp_dir, which)
    if which == "best" and not os.path.exists(path):
        path = checkpoint_path(exp_dir, "latest")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no '{which}' checkpoint in {exp_dir}/{CKPT_DIR}")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    fp = blob.get("vocab_fingerprint")
    if fp is not None and fp != vocab.fingerprint():
        raise ValueError(
            f"vocab fingerprint mismatch: checkpoint {fp} vs {vocab.fingerprint()}"
        )
    if model_cls.input_dim_from_features(cfg):
        # a JAX experiment may keep input_dim's default there: the input
        # width follows the features (see main.train)
        cfg.build(input_dim=feature_config_from(cfg).feature_dim)
    model = model_cls(cfg, vocab.vocab_size)
    model.load_state_dict(blob["state_dict"])
    model = model.to(device)
    if isinstance(model, SpeechTransformer):
        model = model.to(dtype=model.compute_dtype)
    return model.eval(), cfg, feature_config_from(cfg), vocab
