"""Synthetic tone-language corpus generator.

No AISHELL corpus exists in this environment, so full-recipe evidence
(the soak run, the integrated-trainer bench) uses a synthetic stand-in
built to AISHELL-1's measurable contract: 16 kHz PCM16 wavs at 4-10 s
durations, character targets, and a vocab at the real corpus' scale
(~4233 chars — output-projection/CTC-head cost is vocab-bound, so the
model runs at true AISHELL shapes even though only ``n_tone_chars`` of
the vocab ever appear in transcripts).

Each character maps to a distinct pure tone (geometrically spaced
frequencies, ratio ~1.08 so adjacent tones resolve in 80-mel space);
the mapping is learnable to ~zero CER through the real pipeline, which
makes a trained checkpoint's decoded CER a meaningful end-to-end signal
(tests/test_learning.py uses the same construction at toy scale).
"""

from __future__ import annotations

import os
import wave as wavelib

import numpy as np

from ..data.manifest import write_manifest
from ..data.vocab import Vocab

SR = 16000
# CJK block offset for generated "characters" — real multi-byte chars so the
# vocab/detok path is exercised exactly as with AISHELL transcripts
_CJK0 = 0x4E00


def tone_chars(n: int) -> str:
    return "".join(chr(_CJK0 + i) for i in range(n))


def filler_chars(n_tone: int, n_filler: int) -> str:
    return "".join(chr(_CJK0 + n_tone + i) for i in range(n_filler))


def char_freqs(n: int, f_lo: float = 220.0, f_hi: float = 4200.0) -> np.ndarray:
    return f_lo * (f_hi / f_lo) ** (np.arange(n) / max(n - 1, 1))


def synth_wave(
    text: str,
    chars: str,
    freqs: np.ndarray,
    rng: np.random.RandomState,
    tone_sec: float = 0.3,
    noise: float = 0.01,
) -> np.ndarray:
    n = int(SR * tone_sec)
    t = np.arange(n) / SR
    # short fade in/out per tone avoids clicks (broadband transients that
    # smear tone identity across mel bins)
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
    parts = [0.4 * np.sin(2 * np.pi * freqs[chars.index(ch)] * t) * env for ch in text]
    x = np.concatenate(parts) + rng.randn(n * len(text)) * noise
    return np.clip(x, -0.99, 0.99)


def write_wav16(path: str, x: np.ndarray) -> None:
    with wavelib.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((x * 32767).astype(np.int16).tobytes())


def make_synth_corpus(
    out_dir: str,
    n_train: int = 2000,
    n_dev: int = 128,
    n_test: int = 128,
    n_tone_chars: int = 40,
    vocab_size: int = 4233,
    seconds_range: tuple = (4.0, 10.0),
    tone_sec: float = 0.3,
    seed: int = 0,
) -> dict:
    """Write wavs + {train,dev,test}.jsonl + vocab.json under ``out_dir``.

    Returns {"train": path, "dev": path, "test": path, "vocab": path}.
    Idempotent: if the directory already holds a corpus with the same
    parameters (recorded in params.json), it is reused.
    """
    os.makedirs(out_dir, exist_ok=True)
    params = {
        "n_train": n_train, "n_dev": n_dev, "n_test": n_test,
        "n_tone_chars": n_tone_chars, "vocab_size": vocab_size,
        "seconds_range": list(seconds_range), "tone_sec": tone_sec,
        "seed": seed,
    }
    ppath = os.path.join(out_dir, "params.json")
    out = {
        "train": os.path.join(out_dir, "train.jsonl"),
        "dev": os.path.join(out_dir, "dev.jsonl"),
        "test": os.path.join(out_dir, "test.jsonl"),
        "vocab": os.path.join(out_dir, "vocab.json"),
    }
    import json

    if os.path.exists(ppath):
        with open(ppath) as f:
            if json.load(f) == params and all(os.path.exists(p) for p in out.values()):
                return out

    chars = tone_chars(n_tone_chars)
    freqs = char_freqs(n_tone_chars)
    rng = np.random.RandomState(seed)
    lo_len = max(1, int(seconds_range[0] / tone_sec))
    hi_len = max(lo_len, int(seconds_range[1] / tone_sec))

    wav_dir = os.path.join(out_dir, "wav")
    os.makedirs(wav_dir, exist_ok=True)
    splits = {"train": n_train, "dev": n_dev, "test": n_test}
    for split, n in splits.items():
        records = []
        for i in range(n):
            length = rng.randint(lo_len, hi_len + 1)
            text = "".join(chars[rng.randint(n_tone_chars)] for _ in range(length))
            x = synth_wave(text, chars, freqs, rng, tone_sec=tone_sec)
            p = os.path.join(wav_dir, f"{split}_{i:05d}.wav")
            write_wav16(p, x)
            records.append({"wave": p, "tgt": text, "frames": len(x)})
        write_manifest(out[split], records)

    # vocab at AISHELL scale: tone chars first (so they get low ids like
    # frequent chars would), then filler chars that never appear in audio
    v = Vocab()
    sentences = [chars]  # every tone char at least once
    v.consume_sentence_list(sentences)
    fill = filler_chars(n_tone_chars, vocab_size - 4 - n_tone_chars)
    v.consume_sentence_list([fill])
    vocab = v.build(min_count=1, max_vocab=vocab_size)
    vocab.save(out["vocab"])

    with open(ppath, "w") as f:
        json.dump(params, f)
    return out
