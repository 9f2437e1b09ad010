#!/usr/bin/env python
"""Does a hot Noam peak explain the attention plateau? A mid-scale
SpeechTransformer (256d/4h/3+3L, CTC 0.3) on the tone corpus (256
utterances of 3-5 s, vocabulary 200), the same batches and the same init
in each arm (the port of ``scripts/lr_ab_cpu.py``), on one card unless the
caller asks for the CPU:

  hot:         warm-up 150, factor 1.0  (the first soak's schedule)
  gentle:      warm-up 150, factor 0.25
  post_hot:    warm-up 300, factor 1.0,  post-LN, dropout 0.1
  post_gentle: warm-up 300, factor 0.25, post-LN, dropout 0.1

Every ``log_every`` steps one JSON line: CE, CTC, teacher-forced accuracy,
the gradient norm and the seconds so far; up to ``max_steps`` (1000).
On the card the step runs the fbank kernel, the fused attention and the
CTC kernels; ``--device cpu`` runs their plain versions.

    python3 scripts/lr_ab_torch.py hot [--device cpu] [--max_steps 1000]
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from asr_chinese_e2e_tpu_torch.bench import resolve_device  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.batching import BucketedLoader  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import (  # noqa: E402
    SpeechTransformer,
    default_config,
)
from asr_chinese_e2e_tpu_torch.train.optimizer import (  # noqa: E402
    default_train_config,
    make_optimizer,
)
from asr_chinese_e2e_tpu_torch.train.train_step import make_step_fns  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402

ARMS = {
    "hot": dict(warmup=150, factor=1.0),
    "gentle": dict(warmup=150, factor=0.25),
    # the reference's placement and regularisation (post-LN, dropout 0.1)
    # under the hot and the scaled peak: is it the peak or the placement
    # that pins post-LN at the uniform plateau?
    "post_hot": dict(warmup=300, factor=1.0, norm="post", dropout=0.1),
    "post_gentle": dict(warmup=300, factor=0.25, norm="post", dropout=0.1),
}


def run_arm(arm: str, device: str = "cuda", max_steps: int = 1000, log_every: int = 25,
            corpus_dir: str = os.path.join(REPO, "build", "lr_ab_corpus")) -> list:
    """Train one arm; returns the logged rows."""
    dev = resolve_device(device)
    a = ARMS[arm]
    paths = make_synth_corpus(
        corpus_dir, n_train=256, n_dev=32, n_test=32, n_tone_chars=40, vocab_size=200,
        seconds_range=(3.0, 5.0), tone_sec=0.3, seed=7,
    )
    vocab = Vocab.load(paths["vocab"])
    feat_cfg = FeatureConfig(fbank_impl="pallas")  # 80 mel, LFR 4/3: the flagship's 320
    mcfg = default_config().build(
        d_model=256, num_heads=4, head_dim=64, d_ff=512, num_encoder_layers=3,
        num_decoder_layers=3, input_dim=feat_cfg.feature_dim,
        dropout_rate=a.get("dropout", 0.0), ctc_weight=0.3, norm_type=a.get("norm", "pre"),
        attn_impl="fused",
    )
    tcfg = default_train_config().combine(mcfg).build(
        lr_schedule="noam", warmup=a["warmup"], noam_factor=a["factor"], ctc_weight=0.3,
    )
    model = SpeechTransformer(mcfg, vocab.vocab_size, torch.Generator().manual_seed(0)).to(dev)
    optimizer = make_optimizer(model.parameters(), tcfg, mcfg.d_model)
    init_fn, train_step, _ = make_step_fns(model, optimizer, feat_cfg, tcfg)
    loader = BucketedLoader(
        paths["train"], vocab, batch_size=32, max_target_len=20, seed=0,
        bucket_seconds=(5.0,), prefetch=0,
    )
    state = init_fn()
    rows = []
    t0 = time.time()
    print(f"=== arm {arm}: warmup {a['warmup']} factor {a['factor']} on {dev} ===", flush=True)
    epoch = 0
    while state.step < max_steps:
        for b in loader.epoch(epoch):
            batch = [torch.from_numpy(x).to(dev)
                     for x in (b.wave, b.wave_lengths, b.labels, b.label_lengths)]
            state, m = train_step(state, *batch, 0)
            if state.step % log_every == 0:
                row = {
                    "arm": arm, "step": state.step,
                    "ce": round(float(m["ce_loss"]), 3),
                    "ctc": round(float(m["ctc_loss"]), 3),
                    "acc": round(float(m["n_correct"]) / max(float(m["n_word"]), 1.0), 3),
                    "gnorm": round(float(m["grad_norm"]), 2),
                    "t": round(time.time() - t0, 1),
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
            if state.step >= max_steps:
                break
        epoch += 1
    print(f"=== arm {arm} done at step {state.step}, {time.time() - t0:.0f}s ===", flush=True)
    return rows


if __name__ == "__main__":
    from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs

    positional, kwargs = parse_kwargs(sys.argv[1:])
    run_arm(positional[0] if positional else "hot", **kwargs)
