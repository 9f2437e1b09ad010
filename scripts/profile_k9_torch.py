#!/usr/bin/env python
"""K9, the rescore mode's device CTC prefix beam, on one GPU, by two
measures: the device time of its two kernels per launch under
``torch.profiler`` (``prefix_beam_rows_kernel``, the row pass, and
``prefix_beam_recursion_kernel``, the search over frames; 20 calls), and 20
calls of the dispatcher ``ctc_prefix_beam_device`` back to back under CUDA
events (median of 10), at beam 10, prune 8 and L 64 (what ``recognize``
sends), on two inputs:

- (8, 134, 4233): the flagship's CTC log-probs of ``chip_smoke.py`` phase
  8's first serving batch (random weights from seed 0, lengths 81-131);
- (8, 512, 4233): 15 s of phase 8b's peaky rows (``chip_smoke._peaky_rows``,
  seed 3).

It also prints the recursion's time per frame: its device time over the
longest utterance's frames, the chain every block walks.

``--root`` names the checkout whose package and kernels are measured
(default: the one that holds this script), so that two versions of K9 are
timed on one card in one run, each in its own process. The inputs are made
once, by the first run, into ``--inputs`` (default
``build/profile_k9/inputs.pt`` beside this script's checkout), and every
later run reads them, so all runs see the same tensors:

    python3 scripts/profile_k9_torch.py [--root DIR] [--inputs FILE]

The kernels are built from that checkout at first use.
"""

import argparse
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = dict(beam_size=10, prune=8, max_prefix_len=64)
N_CALLS = 20
WARMUP_LAUNCHES = 64
KERNELS = {"rows": "prefix_beam_rows_kernel", "recursion": "prefix_beam_recursion_kernel"}


def flagship_log_probs(chip_smoke, dev, work):
    """The flagship's f32 CTC log-probs and lengths on phase 8's first
    serving batch: its synthetic corpus and random weights from seed 0."""
    import torch

    corpus = chip_smoke.make_synth_corpus(
        os.path.join(work, "corpus"), n_train=0, n_dev=0, n_test=16, n_tone_chars=40,
        vocab_size=4233, seconds_range=(2.0, 8.0), seed=0)
    vocab = chip_smoke.Vocab.load(corpus["vocab"])
    exp = os.path.join(work, "exp")
    os.makedirs(exp, exist_ok=True)
    cfg = chip_smoke.flagship_config("bfloat16")
    cfg.save(os.path.join(exp, "config.json"))
    model = chip_smoke.SpeechTransformer(cfg, vocab.vocab_size, torch.Generator().manual_seed(0))
    chip_smoke.save_torch_checkpoint(exp, model.state_dict(), vocab.fingerprint(), "best")
    model, _, feat_cfg, _ = chip_smoke.load_experiment(exp, corpus["vocab"], "best", device=dev)
    enc, lens = chip_smoke._first_batch(model, feat_cfg, corpus["test"], dev)
    with torch.inference_mode():
        return model.ctc_log_probs(enc).float(), lens


def inputs(chip_smoke, dev, path):
    """{name: (log-probs, lengths)} on ``dev``, made once into ``path``."""
    import torch

    if not os.path.exists(path):
        work = os.path.dirname(path)
        os.makedirs(work, exist_ok=True)
        made = {"flagship": flagship_log_probs(chip_smoke, dev, work),
                "15 s": chip_smoke._peaky_rows(dev, 8, 512, seed=3)}
        torch.save({k: (x.cpu(), n.cpu()) for k, (x, n) in made.items()}, path)
    return {k: (x.to(dev), n.to(dev)) for k, (x, n) in torch.load(path).items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose K9 is measured")
    ap.add_argument("--inputs", default=os.path.join(HERE, "build", "profile_k9", "inputs.pt"),
                    help="the inputs' file, made by the first run")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_k9_torch: CUDA is not available")
    import chip_smoke  # that checkout's

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; checkout {root}")
    dev = torch.device("cuda", 0)
    for what, (x, n) in inputs(chip_smoke, dev, os.path.abspath(opts.inputs)).items():

        def call():
            return chip_smoke.ctc_prefix_beam_device(x, n, **ARGS)

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # spin kernels first: a process that has traced before can lose
            # the card's records of the first launches after a start
            for _ in range(WARMUP_LAUNCHES):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(N_CALLS):
                call()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            for part, kernel in KERNELS.items():
                if kernel in e.key and e.count:
                    parts[part] = e.self_device_time_total / e.count / 1e3
        if set(parts) != set(KERNELS):
            raise SystemExit(f"profile_k9_torch: the profiler saw {sorted(parts)} of K9's kernels")
        samples = []
        for _ in range(10):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(N_CALLS):
                call()
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end) / N_CALLS)
        frames = int(n.clamp(max=x.shape[1]).max())
        print(f"K9 {what} {tuple(x.shape)} lengths {n.tolist()}: row pass {parts['rows']:.4f} "
              f"ms + recursion {parts['recursion']:.4f} ms a launch (profiler, {N_CALLS} "
              f"calls); recursion {parts['recursion'] / frames * 1e3:.3f} us a frame over "
              f"{frames} frames; {N_CALLS} calls back to back "
              f"{statistics.median(samples):.4f} ms a call (median of 10)")


if __name__ == "__main__":
    main()
