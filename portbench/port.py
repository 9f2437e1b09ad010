"""The system under test, built from a configuration file through the
port's own entry points (``asr_chinese_e2e_tpu_torch``): its model, its
train step, each utterance's loss as its own losses give it, an experiment
directory that its ``recognize`` loads, and its launch counters. The
drivers take the program from here and from nothing else."""

from __future__ import annotations

import contextlib
import json
import os

import torch

from asr_chinese_e2e_tpu_torch.core.config import Config
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab
from asr_chinese_e2e_tpu_torch.losses import model_loss
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer, default_config
from asr_chinese_e2e_tpu_torch.ops import ctc_kernel, fbank, fused_attention
from asr_chinese_e2e_tpu_torch.ops import ctc_prefix_beam_kernel
from asr_chinese_e2e_tpu_torch.train.optimizer import (
    default_train_config,
    make_optimizer,
    model_width,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns
from asr_chinese_e2e_tpu_torch.utils.experiment import save_torch_checkpoint

# the port's launch counters, by the name the harness records them under
COUNTERS = {
    "K1": fused_attention.fused_attention_general,
    "K2": fused_attention.attention_backward_kernel,
    "K3": ctc_kernel.ctc_alpha_kernel,
    "K4": ctc_kernel.ctc_beta_kernel,
    "K5": fbank.log_mel_spectrogram_kernel,
    "K9": ctc_prefix_beam_kernel.ctc_prefix_beam_kernel,
}


def launches() -> dict:
    return {k: int(fn.launches) for k, fn in COUNTERS.items()}


def feature_config(config: dict) -> FeatureConfig:
    return FeatureConfig(**config["features"])


def model_config(config: dict) -> Config:
    return default_config().build(**config["model"])


def train_config(config: dict) -> Config:
    return default_train_config().combine(model_config(config)).build(**config["train"])


def build_train_step(config: dict, weights: dict, device):
    """(state, train_step) of a model holding ``weights``: the port's
    ``make_step_fns`` over its ``SpeechTransformer`` and ``Optimizer``."""
    cfg, tcfg = model_config(config), train_config(config)
    model = SpeechTransformer(cfg, config["vocab_size"], torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(weights)
    optimizer = make_optimizer(model.parameters(), tcfg, model_width(cfg))
    init_fn, train_step, _ = make_step_fns(model, optimizer, feature_config(config), tcfg)
    return init_fn(), train_step


@contextlib.contextmanager
def forward_outputs(model):
    """Collects, detached, the output of every call of ``model`` inside the
    block (the train step's forward, as the step made it)."""
    seen = []

    def keep(module, args, out):
        seen.append({k: v.detach() for k, v in out.items() if torch.is_tensor(v)})

    handle = model.register_forward_hook(keep)
    try:
        yield seen
    finally:
        handle.remove()


@torch.no_grad()
def utterance_losses(config: dict, out: dict, labels, label_lengths) -> list:
    """Each utterance's loss from a forward's output ``out``: the port's
    ``model_loss`` over that utterance's rows alone (ctc_weight x its CTC
    NLL + (1 - ctc_weight) x its mean smoothed CE over its targets)."""
    tcfg = train_config(config)
    args = (float(tcfg.get("ctc_weight", 0.0)), float(tcfg.get("label_smoothing", 0.0)),
            tcfg.get("ctc_impl", "pallas"))
    keys = [k for k in ("logits", "gold", "ctc_logits", "enc_lengths") if k in out]
    # each row copied: the CTC kernel wants its logits on a 16-byte boundary
    rows = [model_loss({k: out[k][i : i + 1].clone() for k in keys}, labels[i : i + 1],
                       label_lengths[i : i + 1], *args)[0]
            for i in range(out["gold"].shape[0])]
    return torch.stack(rows).double().cpu().tolist()


def first_moments(state, name_of) -> dict:
    """{leaf name: Adam's first moment} of the port's optimizer (zeros for a
    leaf that it holds no state of)."""
    adam = state.optimizer.adam
    return {name_of[id(p)]: adam.state[p]["exp_avg"] if p in adam.state else torch.zeros_like(p)
            for p in state.optimizer.params}


def parameter_names(state) -> dict:
    return {id(p): n for n, p in state.model.named_parameters()}


def vocab_tokens(size: int) -> list:
    """The port's specials, then CJK ideographs: ``size`` tokens."""
    return ["$", "%", "^", "&"] + [chr(0x4E00 + i) for i in range(size - 4)]


def write_experiment(config: dict, weights: dict, root: str) -> tuple:
    """An experiment directory under ``root`` that ``recognize`` loads:
    the vocabulary, ``config.json`` and ``torch_checkpoints/best.pt`` with
    ``weights``. Returns (exp_dir, vocab_path)."""
    vocab_path = os.path.join(root, "vocab.json")
    with open(vocab_path, "w") as f:
        json.dump({"id2token": vocab_tokens(config["vocab_size"]),
                   "specials": ["$", "%", "^", "&"]}, f, ensure_ascii=False)
    exp = os.path.join(root, "exp")
    os.makedirs(exp, exist_ok=True)
    full = dict(config["features"], **config["model"], **config["train"])
    full["model_name"] = "SpeechTransformer"
    Config(**full).save(os.path.join(exp, "config.json"))
    save_torch_checkpoint(exp, {k: v.cpu() for k, v in weights.items()},
                          Vocab.load(vocab_path).fingerprint(), "best")
    return exp, vocab_path
