"""Wav reading for the serving path (``data/batching.py:34,47-66`` of the
JAX package, without its training loader)."""

from __future__ import annotations

import wave as wavelib

import numpy as np

# duration bucket boundaries in seconds (``data/batching.py:34``)
DEFAULT_BUCKET_SECONDS = (2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 15.0)


def load_wav(path: str, dtype=np.float32) -> np.ndarray:
    """PCM16 wav -> float32 in [-1, 1), downmixing channels by mean.
    ``dtype=np.int16`` returns raw samples instead (the int16 wire format;
    ``parse_batch`` scales by 1/32768)."""
    with wavelib.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"{path}: only PCM16 supported, got width {width}")
    xi = np.frombuffer(raw, dtype=np.int16)
    if dtype == np.int16:
        if n_ch > 1:
            xi = np.rint(xi.reshape(-1, n_ch).mean(axis=1)).astype(np.int16)
        return xi
    x = xi.astype(np.float32) / 32768.0
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x
