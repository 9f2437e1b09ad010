"""Null model: runs the whole trainer loop with trivial compute
(``asr_chinese_e2e_tpu/models/example.py``, itself after the reference's
``Predictor/Models/example_model.py:9-66``): mean-pooled features -> Dense
-> ReLU -> Dense, the same logits at every target position."""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import Config
from .layers import Dense
from .rnn import init_weights
from .transformer import preprocess_targets


def default_config() -> Config:
    return Config(
        embedding_size=100,  # example_model.py:44-51
        hidden_size=300,
        input_dim=320,
        ctc_weight=0.0,
        label_smoothing=0.0,
        max_target_len=128,
        dtype="float32",
    )


class ExampleModel(nn.Module):
    """``generator`` seeds the weight init (default seed 0): lecun-normal
    kernels, zero biases, as flax's ``nn.Dense``."""

    @staticmethod
    def input_dim_from_features(cfg: Config) -> bool:
        """flax infers the first layer's input width from the data."""
        return True

    def __init__(self, cfg: Config, vocab_size: int, generator=None):
        super().__init__()
        self.cfg, self.vocab_size = cfg, vocab_size
        self.hidden = Dense(cfg.input_dim, cfg.hidden_size)
        self.out = Dense(cfg.hidden_size, vocab_size)
        init_weights(self, generator)

    def forward(self, feats, feat_lengths, labels, label_lengths, rng=None):
        h = torch.relu(self.hidden(feats.float().mean(dim=1)))
        ys_in, ys_out = preprocess_targets(labels, label_lengths)
        logits = self.out(h)[:, None, :].expand(-1, ys_out.shape[1], -1)
        return {"logits": logits, "gold": ys_out}
