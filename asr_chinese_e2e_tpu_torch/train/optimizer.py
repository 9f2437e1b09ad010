"""Optimizer: global-norm clipping, then Adam on a learning-rate schedule
(``asr_chinese_e2e_tpu/train/optimizer.py``, an ``optax.chain`` of
``clip_by_global_norm`` and ``adam``).

- Noam ``factor * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)`` with
  step counted from 1: update ``n`` (from 0) uses the schedule at ``n + 1``
  (``optimizer.py:29``); the anneal (lr / k every interval) and constant
  schedules;
- clipping with optax's formula: gradients are scaled by
  ``max_norm / norm`` only when ``norm >= max_norm`` (torch's
  ``clip_grad_norm_`` would scale by ``max_norm / (norm + 1e-6)`` always);
- Adam (0.9, 0.98, 1e-9) is ``torch.optim.Adam`` (fused on the card) over
  the float32 master weights, so its moments are float32 too.

The update count is part of the optimizer state, so a checkpoint restores
the learning-rate trajectory exactly.

Under a mesh: ``step(data_group)`` sums the gradients over the ``data``
axis first (one ``all_reduce`` of them all, flattened: the loss is
normalised over the global batch, so the sum is the global gradient;
tensor-parallel chunks are reduced over ``data`` only, as every other
parameter). The clip's norm then counts the chunks of split parameters
(``parallel/sharding.py::sharded_parameters``) summed over the ``model``
axis. Adam's moments are made per parameter, so a chunk's moments are
chunks too.
"""

from __future__ import annotations

import warnings

import torch

from ..core.config import Config
from ..parallel.collectives import all_reduce_sum


def noam_schedule(d_model: int, warmup: int, factor: float = 1.0):
    def schedule(count: int) -> float:
        step = float(count + 1)  # counts from 0; Noam from 1
        return factor * (d_model ** -0.5) * min(step ** -0.5, step * warmup ** -1.5)

    return schedule


def anneal_schedule(lr: float, anneal: float, steps_per_anneal: int):
    """AnnealingOpt semantics: lr divided by ``anneal`` every interval."""

    def schedule(count: int) -> float:
        return lr / anneal ** (count // steps_per_anneal)

    return schedule


def default_train_config() -> Config:
    """Trainer/optimizer knobs with reference defaults (``main.py:15-35,103``)."""
    return Config(
        lr=3e-4,
        adam_b1=0.9,
        adam_b2=0.98,
        adam_eps=1e-9,
        warmup=4000,
        noam_factor=1.0,
        lr_schedule="noam",  # noam | anneal | constant
        anneal_factor=1.1,
        anneal_every=10000,
        grad_clip=5.0,
        batch_size=64,
        num_epoch=200,
        log_every_iter=100,
        eval_every_iter=5000,
        save_every_iter=5000,
        reference="-loss",  # best-checkpoint criterion (trainer11.py:26,43)
        seed=0,
        exp_root="ckpt",
        exp_name=None,
    )


def make_schedule(cfg: Config, d_model: int):
    if cfg.lr_schedule == "noam":
        return noam_schedule(d_model, cfg.warmup, cfg.noam_factor)
    if cfg.lr_schedule == "anneal":
        return anneal_schedule(cfg.lr, cfg.anneal_factor, cfg.anneal_every)
    return lambda count: cfg.lr


def model_width(cfg: Config) -> int:
    """The width Noam scales by: ``d_model``, else ``hidden_size`` (the RNN
    family), else 512, as the JAX package's trainer takes it."""
    return cfg.get("d_model", cfg.get("hidden_size", 512))


def noam_peak_lr(d_model: int, warmup: int, factor: float = 1.0) -> float:
    """The schedule's maximum (reached at step == warmup)."""
    return factor * d_model ** -0.5 * warmup ** -0.5


# Noam peaks far above the reference recipe's 7e-4 (warmup 4000, d 512)
# were measured to stall the attention decoder (BENCH_NOTES r4).
NOAM_PEAK_WARN = 2e-3


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, float32, on their device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place: leave the gradients as
    they are when their global norm is below ``max_norm``, else scale them
    by ``max_norm / norm``. Returns the norm before clipping (no host
    sync)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def reduce_gradients_(grads, group) -> None:
    """Sum the gradients over ``group`` in place, as one flat buffer."""
    if group is None or not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


class Optimizer:
    """Clip, then Adam at ``schedule(count)``; ``count`` is the number of
    updates taken. ``set_tensor_parallel(model_group, sharded_ids)`` names
    the parameters that hold chunks split over ``model``."""

    model_group = None
    sharded = frozenset()

    def __init__(self, params, cfg: Config, d_model: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg, d_model)
        self.max_norm = float(cfg.grad_clip)
        fused = all(p.device.type == "cuda" for p in self.params)
        self.adam = torch.optim.Adam(
            self.params, lr=0.0, betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            fused=fused or None,
        )
        self.count = 0

    def set_tensor_parallel(self, model_group, sharded_ids) -> None:
        self.model_group, self.sharded = model_group, frozenset(sharded_ids)

    def step(self, data_group=None) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (summed over
        ``data_group`` first); returns the global gradient norm before
        clipping."""
        grads = [p.grad for p in self.params]
        reduce_gradients_(grads, data_group)
        if self.model_group is None:
            norm = clip_by_global_norm_(grads, self.max_norm)
        else:
            norm = self._clip_split_(grads)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
        return norm

    def _clip_split_(self, grads) -> torch.Tensor:
        """``clip_by_global_norm_`` when some gradients are chunks: their
        squares are summed over the model axis."""
        split = [g for p, g in zip(self.params, grads) if id(p) in self.sharded]
        whole = [g for p, g in zip(self.params, grads) if id(p) not in self.sharded]
        sq_split = global_norm(split).square() if split else torch.zeros((), device=grads[0].device)
        sq = all_reduce_sum(sq_split.clone(), self.model_group)
        if whole:
            sq = sq + global_norm(whole).square()
        norm = torch.sqrt(sq)
        scale = torch.where(norm < self.max_norm, torch.ones_like(norm), self.max_norm / norm)
        torch._foreach_mul_(grads, scale)
        return norm

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params, cfg: Config, d_model: int) -> Optimizer:
    if cfg.get("lr_schedule") == "noam":
        peak = noam_peak_lr(d_model, cfg.warmup, cfg.noam_factor)
        if peak > NOAM_PEAK_WARN:
            warnings.warn(
                f"Noam peak LR {peak:.2e} (noam_factor/sqrt(d_model*warmup)) "
                f"exceeds {NOAM_PEAK_WARN:.0e} — measured to stall attention-"
                "decoder learning at flagship depth (BENCH_NOTES r4); lower "
                "noam_factor or raise warm_up so the peak lands near the "
                "reference recipe's 7e-4.",
                stacklevel=2,
            )
    return Optimizer(params, cfg, d_model)


def current_lr(cfg: Config, d_model: int, step: int) -> float:
    """Host-side learning-rate readout for logging."""
    return float(make_schedule(cfg, d_model)(step))
