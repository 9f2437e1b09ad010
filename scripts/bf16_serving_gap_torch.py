#!/usr/bin/env python
"""Where the flagship's bf16 serving chain, card against CPU, parts: phase
8's bf16 chain of ``chip_smoke.py`` (seed-0 flagship, bf16, the corpus'
first ``--utts`` test utterances in batches of 8, beam 10 over 12 steps)
on one CUDA card and on the CPU, taken apart:

- the beam's n-best on each run: how many rows have the CPU bf16 run's
  tokens, and the score distance on those rows (phase 8's reading);
- the CPU bf16 run's n-best paths scored by every run, teacher-forced
  (one cached decode step a position, no search): the distance of the
  path scores and, per position, of the path tokens' log-probs (mean abs
  and mean signed), so a run is compared on the same paths;
- on the card: the search lazy and gather; with
  ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
  on (PyTorch's default) and off; the encoder's attention through K1 and
  through the plain path (``attn_impl="xla"``); the decoder fed the CPU
  bf16 run's encoder output; and the whole chain in f32;
- each run's bias against the CPU f32 run on the same paths: the signed
  mean of the path scores' difference, and of the first step's log-probs
  over the whole vocabulary and over each utterance's 10 likeliest
  tokens (a bias there accumulates over the search's steps, where noise
  grows only as their square root).

Prints the numbers; gates nothing.

    python3 scripts/bf16_serving_gap_torch.py [--utts 16]

The kernels are built from the checkout at first use, as in
``chip_smoke.py``.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig, parse_batch  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import BOS_ID, EOS_ID  # noqa: E402
from asr_chinese_e2e_tpu_torch.decode.beam import beam_search  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402

BEAM, MAX_LEN = cs.SERVE_BF16_BEAM, cs.SERVE_BF16_MAX_LEN
WORK = os.path.join(cs.ROOT, "build", "bf16_serving_gap")


def path_logprobs(model, enc, enc_lens, paths, dev) -> np.ndarray:
    """(B, K, L) log-probs of each path's tokens, teacher-forced from BOS;
    0 after a path's EOS, as the search scores a finished hypothesis."""
    b, k, length = paths.shape
    tok = torch.from_numpy(paths).to(dev).reshape(b * k, length)
    state = model.init_decode_state(enc, enc_lens, length + 1, k)
    prev = torch.full((b * k,), BOS_ID, dtype=torch.int64, device=dev)
    out = []
    for i in range(length):
        lp, state = model.decode_step(prev, state, i)
        out.append(lp.gather(1, tok[:, i:i + 1])[:, 0].float().cpu())
        prev = tok[:, i]
    lp = torch.stack(out, -1).reshape(b, k, length).numpy()
    after_eos = np.cumsum(paths == EOS_ID, -1) - (paths == EOS_ID) > 0
    return np.where(after_eos, 0.0, lp)


def chain(model, pcm, lens, dev, lazy, enc_from=None):
    """One batch: the encoder (or ``enc_from``'s output), the first step
    from BOS, the search."""
    if enc_from is None:
        feat_cfg = FeatureConfig(fbank_impl="pallas")
        feats, feat_lens = parse_batch(pcm.to(dev), lens.to(dev), feat_cfg)
        enc, enc_lens = model.encode(feats, feat_lens)
    else:
        enc, enc_lens = enc_from["enc"].to(dev), enc_from["enc_lens"].to(dev)
    state = model.init_decode_state(enc, enc_lens, MAX_LEN + 1, 1)
    bos = torch.full((enc.shape[0],), BOS_ID, dtype=torch.int64, device=dev)
    first, _ = model.decode_step(bos, state, 0)
    res = beam_search(model, enc, enc_lens, BEAM, MAX_LEN, lazy=lazy).materialize()
    return {"enc": enc, "enc_lens": enc_lens, "first": first.float().cpu(),
            "tokens": res.tokens, "scores": res.scores}


def main(utts: int = 16) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bf16_serving_gap_torch: CUDA is not available")
    print(f"card: {cs.card_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build()
    _build.load_library()
    corpus = make_synth_corpus(
        os.path.join(WORK, "corpus"), n_train=0, n_dev=0, n_test=16, n_tone_chars=40,
        vocab_size=4233, seconds_range=(2.0, 8.0), seed=0,
    )
    weights = SpeechTransformer(cs.flagship_config("bfloat16"), 4233,
                                torch.Generator().manual_seed(0)).state_dict()
    batches = cs._test_batches(corpus, utts)
    # name: (dtype, device, lazy search, reduced-precision reduction, config
    # overrides, the run whose encoder output the decoder takes)
    arms = {
        "cpu bf16": ("bfloat16", "cpu", True, True, {}, None),
        "cpu f32": ("float32", "cpu", True, True, {}, None),
        "card bf16 lazy": ("bfloat16", dev, True, True, {}, None),
        "card bf16 gather": ("bfloat16", dev, False, True, {}, None),
        "card bf16, reduced-precision reduction off": ("bfloat16", dev, True, False, {}, None),
        "card bf16, encoder attention plain (xla)": (
            "bfloat16", dev, True, True, {"attn_impl": "xla"}, None),
        "card bf16 decoder on the cpu bf16 encoder output": (
            "bfloat16", dev, True, True, {}, "cpu bf16"),
        "card f32": ("float32", dev, True, True, {}, None),
    }
    per_batch, fixed = {}, {}
    with torch.inference_mode():
        for name, (dtype, device, lazy, reduced, over, enc_from) in arms.items():
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
            model = SpeechTransformer(cs.flagship_config(dtype).build(**over), 4233)
            model.load_state_dict(weights)
            model = model.eval().to(device)
            per_batch[name] = [
                chain(model, pcm, lens, device, lazy, per_batch[enc_from][i] if enc_from else None)
                for i, (pcm, lens) in enumerate(batches)]
            # the cpu bf16 run's n-best paths (the first arm's), scored by this run
            fixed[name] = np.concatenate([
                path_logprobs(model, r["enc"], r["enc_lens"], ref["tokens"], device)
                for r, ref in zip(per_batch[name], per_batch["cpu bf16"])])
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    runs = {name: {"first": torch.cat([r["first"] for r in rs]),
                   "tokens": np.concatenate([r["tokens"] for r in rs]),
                   "scores": np.concatenate([r["scores"] for r in rs])}
            for name, rs in per_batch.items()}
    ref = runs["cpu bf16"]
    paths = ref["tokens"]
    truth = runs["cpu f32"]["first"]
    top = truth.topk(10, dim=-1).indices
    print(f"teacher-forced scores of the cpu bf16 n-best vs its search's scores: max abs "
          f"{np.abs(fixed['cpu bf16'].sum(-1) - ref['scores']).max():.6g}")
    for name in arms:
        bias = runs[name]["first"] - truth
        print(f"{name} vs cpu f32: signed mean of the path scores' difference "
              f"{(fixed[name] - fixed['cpu f32']).sum(-1).mean():.6g}; first step signed "
              f"mean over the vocabulary {bias.mean().item():.6g}, over the 10 likeliest "
              f"{bias.gather(1, top).mean().item():.6g}")
        if name == "cpu bf16":
            continue
        r = runs[name]
        agree = (r["tokens"] == paths).all(-1)
        best = (r["tokens"][:, 0] == paths[:, 0]).all(-1)
        d = np.abs(r["scores"][agree] - ref["scores"][agree]) if agree.any() else np.zeros(1)
        first = (r["first"] - ref["first"]).abs()
        print(f"{name} vs cpu bf16: best equal {int(best.sum())} of {best.size}, n-best rows "
              f"equal {int(agree.sum())} of {agree.size}; their scores max {d.max():.6g} mean "
              f"{d.mean():.6g}; first step max {first.max().item():.6g} mean "
              f"{first.mean().item():.6g}")
        dp = fixed[name] - fixed["cpu bf16"]
        score = np.abs(dp.sum(-1))
        print(f"  on the cpu bf16 n-best paths (teacher-forced, {score.size} paths): path score "
              f"max {score.max():.6g} mean {score.mean():.6g}; signed mean of the path sums "
              f"{dp.sum(-1).mean():.6g}")
        print("  per position, mean |d log-prob|: "
              + " ".join(f"{v:.4g}" for v in np.abs(dp).mean((0, 1)))
              + "; mean signed: " + " ".join(f"{v:.3g}" for v in dp.mean((0, 1))))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--utts", type=int, default=16)
    main(parser.parse_args().utts)
