#!/usr/bin/env python
"""Streaming recognizer latency of the port at every duration bucket, at the
flagship's widths (512d/8h/6+6L, vocabulary 4233, bf16), on one H100
unless the caller asks for the CPU (the port of ``scripts/bench_stream.py``).

For each final mode (``ctc_greedy``, ``beam``, ``joint``) and bucket, the
two paths of ``StreamingRecognizer`` (``asr_chinese_e2e_tpu_torch/stream.py``):

- **partial**: ``_run_encode`` (the open prefix zero-padded to its bucket:
  K5, then the encoder with K1) + ``_ctc_text`` (CTC greedy collapse and
  detokenisation): the cost of a live caption;
- **final**: ``_final_text``: the mode's decode of the closed segment
  (``joint``: K8 once a decode step).

Then the incremental arm (the same weights with the causal band 50 and
fixed CMVN -18 / 6): partials each 1 s of the last bucket's segment
(``_inc_advance`` + ``_inc_text``: one chunk encode in plain torch and the
host collapse, independent of the prefix), mean and p95, and the final
from the accumulated encoder output (``_inc_final_text``).

Latency does not depend on the weights: random weights from seed 0. Each
path is timed on the host's clock and ends in a host read of its text.

    python3 scripts/bench_stream_torch.py [--n_iters 10 --bucket_seconds 2,4,8]
    python3 scripts/bench_stream_torch.py --device cpu --d_model 64 --num_heads 2 ...

The last line is one JSON object of the rows and the card (``nvidia-smi``'s
name and power limit).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_decode_torch import serving_config, serving_model  # noqa: E402

from asr_chinese_e2e_tpu_torch.bench import card_of, resolve_device  # noqa: E402
from asr_chinese_e2e_tpu_torch.core.config import Config  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import FeatureConfig  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import SpeechTransformer  # noqa: E402
from asr_chinese_e2e_tpu_torch.stream import StreamingRecognizer  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.synth import (  # noqa: E402
    char_freqs,
    filler_chars,
    synth_wave,
    tone_chars,
)


def _segment(chars, freqs, rng, sec: float, sr: int) -> np.ndarray:
    """A synthetic int16 utterance of ``sec`` seconds."""
    n_char = max(1, int(sec / 0.3))
    text = "".join(chars[rng.randint(40)] for _ in range(n_char))
    seg = (synth_wave(text, chars, freqs, rng) * 32767).astype(np.int16)
    return seg[: int(sec * sr)]


def main(
    vocab_size: int = 4233,
    dtype: str = "bfloat16",
    beam: int = 10,
    max_len: int = 40,
    n_iters: int = 10,
    bucket_seconds: str = "2,4,8",
    modes: str = "ctc_greedy,beam,joint",
    device: str = "cuda",
    **model_overrides,
) -> dict:
    """Returns {"rows": [(mode, bucket s, partial ms, final ms)],
    "incremental": [{mode, seg_s, partial mean / p95 ms, final ms}]}."""
    dev = resolve_device(device)
    card = card_of(dev)
    print(f"card: {card}", flush=True)
    cfg, feat_cfg = serving_config(dtype, **model_overrides)
    model = serving_model(cfg, vocab_size, dev)

    # a vocabulary over the tone characters, filled to the head's size so
    # that every id an untrained argmax takes detokenises
    chars = tone_chars(40)
    v = Vocab()
    v.consume_sentence_list([chars, filler_chars(40, vocab_size - 44)])
    vocab = v.build(max_vocab=vocab_size)

    rng = np.random.RandomState(0)
    sr = feat_cfg.sample_rate
    rng.randn(2, sr)  # the JAX bench's init wave: the segments below follow its draws

    buckets = [float(s) for s in str(bucket_seconds).split(",")]
    freqs = char_freqs(40)
    rows = []
    for mode in modes.split(","):
        rec = StreamingRecognizer(model, vocab, feat_cfg, mode=mode, bucket_seconds=buckets,
                                  beam_size=beam, max_len=max_len, incremental="off")
        for sec in buckets:
            seg = _segment(chars, freqs, rng, sec, sr)

            # partial path: encode + CTC greedy + detok over the prefix
            t0 = time.perf_counter()
            _, enc_lens, lp = rec._run_encode(seg)
            rec._ctc_text(lp, enc_lens)
            first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(n_iters):
                _, enc_lens, lp = rec._run_encode(seg)
                rec._ctc_text(lp, enc_lens)
            partial_ms = (time.perf_counter() - t0) / n_iters * 1e3

            # final path: the configured mode end to end
            t0 = time.perf_counter()
            rec._final_text(seg)
            final_first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(n_iters):
                rec._final_text(seg)
            final_ms = (time.perf_counter() - t0) / n_iters * 1e3

            rows.append((mode, sec, partial_ms, final_ms))
            print(f"[{mode} bucket={sec:g}s] partial {partial_ms:.1f} ms, final "
                  f"{final_ms:.1f} ms (first calls {first_s:.2f}s/{final_first_s:.2f}s)",
                  flush=True)

    print("\nmode | bucket | partial ms | final ms")
    for mode, sec, p, f in rows:
        print(f"{mode} | {sec:g}s | {p:.1f} | {f:.1f}")

    # -- the incremental (chunked causal-banded) arm -------------------------
    # the same weights: causal_encoder / attention_band change the attention
    # masks, not the parameters; fixed CMVN; a partial is one chunk encode
    # and the host collapse, whatever the prefix's length
    inc_cfg = Config(**cfg.to_dict()).build(causal_encoder=True, attention_band=50)
    inc_feat = FeatureConfig(cmvn_mode="fixed", cmvn_mean=-18.0, cmvn_std=6.0,
                             fbank_impl="pallas")
    inc_model = SpeechTransformer(inc_cfg, vocab_size).to(dev).to(dtype=model.compute_dtype)
    inc_model.load_state_dict(model.state_dict())
    inc_model.eval()
    sec = buckets[-1]
    seg = _segment(chars, freqs, rng, sec, sr)
    cadence = int(1.0 * sr)
    inc = []
    for mode in modes.split(","):
        rec = StreamingRecognizer(inc_model, vocab, inc_feat, mode=mode, bucket_seconds=buckets,
                                  beam_size=beam, max_len=max_len, incremental="on")
        # warm the chunk encode and the final once
        for i in range(cadence, len(seg), cadence):
            rec._inc_advance(0, seg[:i], final=False)
            rec._inc_text()
        rec._inc_final_text(0, seg)
        lat, final_s = [], 0.0
        for _ in range(n_iters):
            rec._inc_reset(-1)  # a fresh segment
            for i in range(cadence, len(seg), cadence):
                t0 = time.perf_counter()
                rec._inc_advance(0, seg[:i], final=False)
                rec._inc_text()
                lat.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            rec._inc_final_text(0, seg)
            final_s += time.perf_counter() - t0
        lat_ms = np.asarray(lat) * 1e3
        inc.append({"mode": mode, "seg_s": sec, "partial_mean_ms": float(lat_ms.mean()),
                    "partial_p95_ms": float(np.percentile(lat_ms, 95)),
                    "final_ms": final_s / n_iters * 1e3})
        print(f"[incremental {mode} seg={sec:g}s] partial cadence mean {lat_ms.mean():.1f} ms "
              f"/ p95 {np.percentile(lat_ms, 95):.1f} ms (prefix-independent), final "
              f"{final_s / n_iters * 1e3:.1f} ms", flush=True)
    out = {"rows": rows, "incremental": inc}
    print(json.dumps({"bench": "stream", "card": card, "n_iters": n_iters, **out}))
    return out


if __name__ == "__main__":
    from asr_chinese_e2e_tpu_torch.utils.cli import parse_kwargs

    _, kwargs = parse_kwargs(sys.argv[1:])
    main(**kwargs)
