#!/usr/bin/env python
"""Where the f32 per-parameter gradient gap of ``chip_smoke.py`` phase 16
(two data-parallel ranks against one process on one CUDA card) comes from.
The flagship's feed-forward blocks use a ReLU: a pre-activation within
rounding of zero takes the other side of the kink in the other run, and
that unit's gradient is then dropped or kept whole. Runs, each the three
phase-16 steps (constant lr, hash dropout 0.1 on the activations, global
batch 16 x 8 s):

- one process, recording each ReLU's sign mask;
- two ranks (gloo on the one card), free, and with every ReLU made to take
  the one process's mask (this rank's rows of it);
- the same two free runs with ``attn_impl="xla"`` (no K1/K2);
- the two free runs in bf16;
- phase 10's card-against-CPU f32 step (2 rows, dropout 0) through the
  kernels, and with the plain attention, the plain CTC recursion or both
  on both sides (``--card-vs-cpu``: this part alone).

Prints, per pair, the losses' and gradient norms' gap, the sign masks that
differ, and the largest per-parameter |diff| / |ref| of the first step's
gradient and of each parameter's move over the steps. Gates nothing.

    python3 scripts/parallel_grad_gap_torch.py [--card-vs-cpu]

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from asr_chinese_e2e_tpu_torch.models import layers  # noqa: E402
from asr_chinese_e2e_tpu_torch.parallel.dryrun import run_ranks  # noqa: E402
from asr_chinese_e2e_tpu_torch.parallel.sharding import batch_rows, make_mesh  # noqa: E402

# the ReLU masks of the feed-forward calls, in call order: recorded when
# "record" is a list, imposed (one popped a call) when "impose" is
MASKS = {"record": None, "impose": None}


def _ffn_forward(self, x, rng=None):
    h = self.w1(x)
    impose = MASKS["impose"]
    y = h * impose.pop(0).to(h.device, h.dtype) if impose is not None else torch.relu(h)
    if MASKS["record"] is not None:
        MASKS["record"].append((h > 0).cpu())
    return self.drop(self.w2(y), rng)


layers.PositionwiseFFN.forward = _ffn_forward


def _run(fn, *args, impose=None, **kwargs):
    """``fn(*args, **kwargs)`` recording the ReLU masks (imposing
    ``impose``'s); returns (its result, the masks)."""
    MASKS["record"], MASKS["impose"] = [], impose
    try:
        return fn(*args, **kwargs), MASKS["record"]
    finally:
        MASKS["record"], MASKS["impose"] = None, None


def _rank(dtype: str, masks_path, overrides: dict) -> dict:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=2)
    impose = None
    if masks_path is not None:
        rows = batch_rows(mesh, chip_smoke.PARALLEL_BATCH)
        impose = [m[rows] for m in torch.load(masks_path)]
    out, masks = _run(chip_smoke._parallel_steps, dtype, dev, mesh, impose=impose, **overrides)
    return {**out, "masks": masks, "rows": batch_rows(mesh, chip_smoke.PARALLEL_BATCH)}


def _flips(masks, ref_masks, rows=slice(None)) -> int:
    return sum(int((m != r[rows]).sum()) for m, r in zip(masks, ref_masks))


def _report(label, got, ref, flips) -> None:
    gaps = chip_smoke.parallel_gaps(got, ref)
    top = sorted(gaps["grads"], key=lambda k: -gaps["grads"][k])[:5]
    g_name, g_gap = chip_smoke.worst(gaps["grads"])
    w_name, w_gap = chip_smoke.worst(gaps["moves"])
    print(f"{label}: ReLU signs that differ {flips}; loss/grad norm max rel {gaps['rel']:.3e}; "
          f"first step's gradient max |diff| / |g| {g_gap:.3e} ({g_name}), move max |diff| / "
          f"|move| {w_gap:.3e} ({w_name}); largest gradient gaps: "
          + ", ".join(f"{k} {gaps['grads'][k]:.2e}" for k in top), flush=True)


def data_parallel(dev, dtype: str, impose: bool, **overrides) -> None:
    ref, ref_masks = _run(chip_smoke._parallel_steps, dtype, dev, None, **overrides)
    path = None
    if impose:
        path = os.path.join(chip_smoke.WORK, "relu_masks.pt")
        os.makedirs(chip_smoke.WORK, exist_ok=True)
        torch.save(ref_masks, path)
    arms = [("free", None)] + ([("ReLU masks imposed", path)] if impose else [])
    for name, masks_path in arms:
        ranks = run_ranks(2, _rank, dtype, masks_path, overrides)
        for r, got in enumerate(ranks):
            _report(f"{dtype} {overrides or 'fused'} two ranks vs one process, {name}, rank {r}",
                    got, ref, _flips(got["masks"], ref_masks, got["rows"]))


CARD_VS_CPU_ARMS = (
    {},
    {"attn_impl": "xla", "decoder_attn_impl": "xla"},
    {"ctc_impl": "scan"},
    {"attn_impl": "xla", "decoder_attn_impl": "xla", "ctc_impl": "scan"},
)


def card_vs_cpu(dev) -> None:
    """Phase 10's f32 step (2 rows, dropout 0) on the CPU and on the card:
    through the kernels, then with the plain attention (no K1/K2), the
    plain CTC recursion (no K3/K4) and both on both sides."""
    batch = chip_smoke.fixed_batch(torch.device("cpu"), 2)
    for overrides in CARD_VS_CPU_ARMS:
        cfg, tcfg, feat = chip_smoke._recipe("float32", dropout_rate=0.0, **overrides)
        tcfg = tcfg.build(spec_augment=False)
        (*cpu, cpu_grads), cpu_masks = _run(chip_smoke._one_step, cfg, tcfg, feat, batch,
                                            torch.device("cpu"))
        (*card, card_grads), masks = _run(chip_smoke._one_step, cfg, tcfg, feat, batch, dev)
        own = {k: float((card_grads[k] - g).norm() / g.norm().clamp_min(1e-30))
               for k, g in cpu_grads.items() if not k.endswith("k_proj.bias")}
        top = sorted(own, key=lambda k: -own[k])[:5]
        print(f"f32 step card vs cpu (2 rows, dropout 0), {overrides or 'kernels'}: ReLU signs "
              f"that differ {_flips(masks, cpu_masks)}; loss rel "
              f"{abs(card[0] - cpu[0]) / cpu[0]:.3e}, grad norm rel "
              f"{abs(card[1] - cpu[1]) / cpu[1]:.3e}; per parameter max |diff| / |g|: "
              + ", ".join(f"{k} {own[k]:.2e}" for k in top), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("parallel_grad_gap_torch: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chip_smoke._build.build()
    if "--card-vs-cpu" not in sys.argv:
        data_parallel(dev, "float32", impose=True)
        data_parallel(dev, "float32", impose=False, attn_impl="xla")
        data_parallel(dev, "bfloat16", impose=False)
    card_vs_cpu(dev)


if __name__ == "__main__":
    main()
