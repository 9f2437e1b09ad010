#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU: builds the CUDA kernels,
holds each against its plain PyTorch version on the card, then drives the
serving path (``asr_chinese_e2e_tpu_torch.recognize``, beam mode) on the
flagship configuration with random weights and checks that it went through
the kernels. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. require CUDA; print the card (``nvidia-smi``); TF32 off;
2. build the kernels (``ops/_build.py``) and print the build time;
3. K5 fbank kernel vs ``log_mel_spectrogram``: abs and rel diff <= 1e-3;
4. K1 attention kernel vs ``attention_reference``: f32 <= 1e-4 abs, bf16
   vs the f32 reference of the same bf16 inputs <= 2e-2 abs, at the
   encoder shapes and the causal / band / rectangular / dropout cases;
   median CUDA-event times of kernel and plain version;
5. the serving path: a 512-wide, 6+6-layer, bf16 SpeechTransformer with a
   4233-token vocabulary decodes 16 synthetic utterances of 2-8 s (beam
   10, batches of 8); every utterance needs a finite-scored hypothesis,
   the fbank kernel must run once and the attention kernel 6 times per
   batch, and the kernel path's f32 encoder output must agree with the
   CPU run of the plain path (which the CPU tests hold to the JAX
   package);
6. print the kernels' JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from asr_chinese_e2e_tpu_torch.core.config import Config  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.features import (  # noqa: E402
    FeatureConfig,
    log_mel_spectrogram,
    parse_batch,
)
from asr_chinese_e2e_tpu_torch.data.io import load_wav  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.manifest import read_manifest  # noqa: E402
from asr_chinese_e2e_tpu_torch.data.vocab import Vocab  # noqa: E402
from asr_chinese_e2e_tpu_torch.models.transformer import (  # noqa: E402
    SpeechTransformer,
    default_config,
)
from asr_chinese_e2e_tpu_torch.ops import _build  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops import fused_attention as fa  # noqa: E402
from asr_chinese_e2e_tpu_torch.ops.fbank import log_mel_spectrogram_kernel  # noqa: E402
from asr_chinese_e2e_tpu_torch.recognize import recognize  # noqa: E402
from asr_chinese_e2e_tpu_torch.utils.experiment import (  # noqa: E402
    save_torch_checkpoint,
)
from asr_chinese_e2e_tpu_torch.utils.synth import make_synth_corpus  # noqa: E402

WORK = os.path.join(ROOT, "build", "chip_smoke")
N_TIMED = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n=N_TIMED, warmup=3) -> float:
    """Median of ``n`` CUDA-event-timed calls of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 3: fbank ------------------------------------------------------------


def check_fbank(dev) -> dict:
    cfg = FeatureConfig()
    rng = np.random.RandomState(0)
    worst, timing = 0.0, None
    for shape in ((8, 128000), (3, 12345)):
        pcm = rng.randint(-32768, 32768, size=shape).astype(np.int16)
        wave = torch.from_numpy(pcm).to(dev).float() * (1.0 / 32768.0)
        got = log_mel_spectrogram_kernel(wave, cfg)
        want = log_mel_spectrogram(wave, cfg)
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"fbank shape {got.shape} vs {want.shape}")
        diff = (got - want).abs()
        max_abs = diff.max().item()
        max_rel = (diff / want.abs().clamp(min=1e-6)).max().item()
        print(f"fbank {shape}: max_abs={max_abs:.3e} max_rel={max_rel:.3e}")
        require(max_abs <= 1e-3 and max_rel <= 1e-3, f"fbank {shape} disagrees")
        worst = max(worst, max_abs)
        if timing is None:
            k_ms = median_ms(lambda: log_mel_spectrogram_kernel(wave, cfg))
            p_ms = median_ms(lambda: log_mel_spectrogram(wave, cfg))
            timing = (k_ms, p_ms)
            print(f"fbank {shape} f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"(median of {N_TIMED})")
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


# -- phase 4: attention --------------------------------------------------------


def _attn_inputs(b, h, tq, tk, d, dev, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, tq, d, generator=g)
    k = torch.randn(b, h, tk, d, generator=g)
    v = torch.randn(b, h, tk, d, generator=g)
    q_len = torch.tensor([max(1, tq - 37 * i) for i in range(b)], dtype=torch.int32)
    k_len = torch.tensor([max(1, tk - 37 * i) for i in range(b)], dtype=torch.int32)
    if tq != tk:  # cross-attention: queries by target length, keys by frames
        q_len = torch.tensor([max(1, tq - 3 * i) for i in range(b)], dtype=torch.int32)
    return [x.to(dev) for x in (q, k, v, q_len, k_len)]


def check_attention(dev) -> dict:
    b, h, d = 8, 8, 64
    scale = 1.0 / 8.0
    cases = [
        # (name, tq, tk, causal, band, rate)
        ("encoder-8s", 267, 267, False, 0, 0.0),
        ("encoder-15s", 501, 501, False, 0, 0.0),
        ("causal", 267, 267, True, 0, 0.0),
        ("band50", 267, 267, False, 50, 0.0),
        ("causal-band50", 267, 267, True, 50, 0.0),
        ("rectangular", 21, 267, False, 0, 0.0),
        ("dropout0.1", 267, 267, False, 0, 0.1),
    ]
    worst, slice_timing = 0.0, None
    for i, (name, tq, tk, causal, band, rate) in enumerate(cases):
        q, k, v, q_len, k_len = _attn_inputs(b, h, tq, tk, d, dev, seed=i)
        args = (q_len, k_len, 1234, scale, rate, causal, band)
        got32 = fa.fused_attention_general(q, k, v, *args)
        want32 = fa.attention_reference(q, k, v, *args)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        got16 = fa.fused_attention_general(qb, kb, vb, *args)
        want16 = fa.attention_reference(qb.float(), kb.float(), vb.float(), *args)
        torch.cuda.synchronize()
        err32 = (got32 - want32).abs().max().item()
        err16 = (got16.float() - want16).abs().max().item()
        print(f"attention {name} (8,8,{tq},{tk},64): f32 max_abs={err32:.3e} "
              f"bf16 max_abs={err16:.3e}")
        require(err32 <= 1e-4, f"attention {name} f32 disagrees")
        require(err16 <= 2e-2, f"attention {name} bf16 disagrees")
        worst = max(worst, err16)
        if name.startswith("encoder"):
            k_ms = median_ms(lambda: fa._launch(qb, kb, vb, *args))
            p_ms = median_ms(lambda: fa.attention_reference(qb, kb, vb, *args))
            print(f"attention {name} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"(median of {N_TIMED})")
            if slice_timing is None:
                slice_timing = (k_ms, p_ms)
    return {"max_abs_err": worst, "ms": slice_timing[0], "plain_ms": slice_timing[1]}


# -- phase 5: the serving path -------------------------------------------------


def flagship_config(dtype: str) -> Config:
    feat = FeatureConfig()
    cfg = default_config().build(
        ctc_weight=0.3, dtype=dtype, attn_impl="fused", fbank_impl="pallas",
        input_dim=feat.feature_dim,
    )
    return Config(**cfg.to_dict())


def check_encoder_against_cpu(corpus, vocab_size, dev) -> float:
    """f32 encoder through the kernels on the card vs the plain path on the
    CPU, two utterances of the corpus."""
    cfg = flagship_config("float32")
    model = SpeechTransformer(cfg, vocab_size, torch.Generator().manual_seed(0)).eval()
    recs = read_manifest(corpus["test"])[:2]
    waves = [load_wav(r["wave"], dtype=np.int16) for r in recs]
    s = max(len(w) for w in waves)
    pcm = np.zeros((2, s), np.int16)
    for i, w in enumerate(waves):
        pcm[i, : len(w)] = w
    lens = torch.tensor([len(w) for w in waves], dtype=torch.int32)
    feat_cfg = FeatureConfig(fbank_impl="pallas")
    with torch.inference_mode():
        f_cpu, fl_cpu = parse_batch(torch.from_numpy(pcm), lens, feat_cfg)
        want, _ = model.encode(f_cpu, fl_cpu)
        model_d = model.to(dev)
        f_d, fl_d = parse_batch(torch.from_numpy(pcm).to(dev), lens.to(dev), feat_cfg)
        got, _ = model_d.encode(f_d, fl_d)
    torch.cuda.synchronize()
    return (got.cpu() - want).abs().max().item()


def run_serving_path(dev) -> dict:
    shutil.rmtree(WORK, ignore_errors=True)
    corpus = make_synth_corpus(
        os.path.join(WORK, "corpus"), n_train=0, n_dev=0, n_test=16,
        n_tone_chars=40, vocab_size=4233, seconds_range=(2.0, 8.0), seed=0,
    )
    vocab = Vocab.load(corpus["vocab"])
    require(vocab.vocab_size == 4233, f"vocab size {vocab.vocab_size}")
    exp = os.path.join(WORK, "exp")
    os.makedirs(exp)
    cfg = flagship_config("bfloat16")
    cfg.save(os.path.join(exp, "config.json"))
    model = SpeechTransformer(cfg, vocab.vocab_size, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    save_torch_checkpoint(exp, model.state_dict(), vocab.fingerprint(), "best")
    print(f"flagship: d_model 512, 8 heads, 6+6 layers, bf16, vocab 4233, "
          f"{n_params} parameters")

    enc_err = check_encoder_against_cpu(corpus, vocab.vocab_size, dev)
    print(f"encoder f32 kernels-on-card vs plain-on-cpu: max_abs={enc_err:.3e}")
    require(enc_err <= 1e-3, "encoder output disagrees with the CPU run")

    log_mel_spectrogram_kernel.launches = 0
    fa.fused_attention_general.launches = 0
    t0 = time.perf_counter()
    res = recognize(
        exp, corpus["vocab"], manifest=corpus["test"], mode="beam", beam_size=10,
        batch_size=8, max_decode_len=64, device="cuda",
        out=os.path.join(WORK, "results.json"),
    )
    wall = time.perf_counter() - t0
    launches = {
        "fbank": log_mel_spectrogram_kernel.launches,
        "attention": fa.fused_attention_general.launches,
    }

    records = read_manifest(corpus["test"])
    utts = res["utts"]
    require(len(records) == 16 and len(utts) == 16, f"{len(utts)} of 16 decoded")
    for utt, entry in utts.items():
        outs = entry["output"]
        require(len(outs) >= 1, f"{utt}: no hypothesis")
        require(all(np.isfinite(o["score"]) for o in outs), f"{utt}: score not finite")
    tm = res["timing"]
    n = tm["batches"]
    require(launches["fbank"] == n, f"fbank launches {launches['fbank']} != {n} batches")
    require(launches["attention"] == 6 * n,
            f"attention launches {launches['attention']} != 6 x {n} batches")
    print(f"recognize: {len(utts)} utterances, {n} batches, {tm['audio_s']:.3f} s audio, "
          f"CER {res['cer']:.2f}% (random weights)")
    print(f"recognize per batch: encode {tm['encode_s'] / n * 1e3:.3f} ms, "
          f"search {tm['search_s'] / n * 1e3:.3f} ms; wall {wall:.3f} s incl. model "
          f"load; audio-s/s {tm['audio_s'] / (tm['encode_s'] + tm['search_s']):.3f} "
          f"(encode+search), {tm['audio_s'] / wall:.3f} (wall)")
    print(f"launches in the recognize run: {launches}")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.3f} s: {lib_path}")

    fbank = check_fbank(dev)
    attn = check_attention(dev)
    launches = run_serving_path(dev)

    kernels = [
        {"name": "fbank", "route": "cuda",
         "source": "asr_chinese_e2e_tpu_torch/ops/csrc/fbank.cu",
         "replaces": "asr_chinese_e2e_tpu/ops/fbank_pallas.py:43",
         "launches": launches["fbank"], **fbank},
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "asr_chinese_e2e_tpu_torch/ops/csrc/fused_attention_fwd.cu",
         "replaces": "asr_chinese_e2e_tpu/ops/fused_attention.py:126",
         "launches": launches["attention"], **attn},
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
