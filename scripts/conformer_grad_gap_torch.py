#!/usr/bin/env python
"""Where the conformer's f32 gradient gap, card against CPU, comes from, on
one CUDA card: the f32 conformer step of ``chip_smoke.py`` phase 14b (a
corpus like phase 9's, two utterances) on the card and on the CPU with the
parameters whose gradients differ most and each parameter's |diff| / |g|,
once through the CTC kernels (K3/K4) and once with the plain CTC recursion
(``ctc_impl=scan``) on both sides; then one ``ConvModule`` and the
depthwise conv's weight gradient alone, card and CPU in f32, each against
a float64 evaluation on the card. With ``--rnn``, the same two steps of
``BiLSTMCTC`` and ``LAS`` (phase 15's f32 step) instead. Prints the
numbers; gates nothing.

    python3 scripts/conformer_grad_gap_torch.py [--rnn]

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.layers import ConvModule  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402


def conv_module_against_f64(dev) -> None:
    """One ``ConvModule`` (d 512, k 15, 64 x 267 frames, 16 frames of
    padding on half the rows) forward and backward in f32 on the card and
    on the CPU, each against float64 on the card; and the depthwise conv's
    weight gradient alone (ATen's ``conv_depthwise2d`` on the card)."""
    gen = torch.Generator().manual_seed(7)
    module = ConvModule(512, 15)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    x = torch.randn(64, 267, 512, generator=gen)
    g = torch.randn(64, 267, 512, generator=gen)
    lens = torch.tensor([267, 251] * 32)
    runs = {}
    for name, device, dtype in (("card f32", dev, torch.float32),
                                ("cpu f32", torch.device("cpu"), torch.float32),
                                ("card f64", dev, torch.float64)):
        m = ConvModule(512, 15, dtype=dtype)
        m.load_state_dict(module.state_dict())
        m = m.to(device, dtype)
        xi = x.to(device, dtype).detach().requires_grad_(True)
        (m(xi, lens) * g.to(device, dtype)).sum().backward()
        runs[name] = {"x": xi.grad, **{k: p.grad for k, p in m.named_parameters()}}
    ref = {k: v.double().cpu() for k, v in runs["card f64"].items()}
    for name in ("card f32", "cpu f32"):
        rel = {k: float((v.double().cpu() - ref[k]).norm() / ref[k].norm())
               for k, v in runs[name].items()}
        print(f"ConvModule gradients, {name} vs float64 on the card: "
              + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    y = torch.randn(64, 512, 281, generator=gen)
    gy = torch.randn(64, 512, 267, generator=gen)
    w = torch.randn(512, 1, 15, generator=gen) * 0.05
    dw = {}
    for name, device, dtype in (("card f32", dev, torch.float32),
                                ("cpu f32", torch.device("cpu"), torch.float32),
                                ("card f64", dev, torch.float64)):
        wi = w.to(device, dtype).detach().requires_grad_(True)
        (F.conv1d(y.to(device, dtype), wi, groups=512) * gy.to(device, dtype)).sum().backward()
        dw[name] = wi.grad.double().cpu()
    print("depthwise conv weight gradient (64, 512, 281) k 15 vs float64 on the card: "
          + ", ".join(f"{n} {float((dw[n] - dw['card f64']).norm() / dw['card f64'].norm()):.2e}"
                      for n in ("card f32", "cpu f32")))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("conformer_grad_gap_torch: CUDA is not available")
    print(f"card: {chip_smoke.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    corpus = make_synth_corpus(
        os.path.join(chip_smoke.WORK, "grad_gap_corpus"), n_train=2, n_dev=0, n_test=0,
        n_tone_chars=40, vocab_size=chip_smoke.VOCAB, seconds_range=(7.5, 8.0), seed=1,
    )
    models = ([{"model_name": n} for n in ("BiLSTMCTC", "LAS")] if "--rnn" in sys.argv[1:]
              else [chip_smoke.CONFORMER])
    for model in models:
        name = model.get("model_name", "conformer")
        for label, extra in ((name, {}), (f"{name} ctc_impl=scan", {"ctc_impl": "scan"})):
            try:
                chip_smoke.check_step_against_cpu(corpus, dev, label=label, worst_grads=6,
                                                  grad_rel=1e-5, **extra, **model)
            except AssertionError as err:  # printed, not gated
                print(f"{label}: {err}")
    if "--rnn" not in sys.argv[1:]:
        conv_module_against_f64(dev)


if __name__ == "__main__":
    main()
