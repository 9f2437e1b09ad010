"""ctypes bindings for the native (C++) host-IO library (a copy of the JAX
package's jax-free ``data/native.py``, building the same ``cpp/wavio.cc``).

Builds ``cpp/wavio.cc`` on demand with g++ (cached in ``cpp/build/``) and
exposes batch wav decoding. Falls back cleanly when no compiler is
available — callers check ``available()``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_SRC = os.path.join(_REPO_ROOT, "cpp", "wavio.cc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "cpp", "build")
_SO = os.path.join(_BUILD_DIR, "libwavio.so")

_lock = threading.Lock()
_lib: "Optional[ctypes.CDLL]" = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        _SRC, "-o", _SO,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.wavio_read.restype = ctypes.c_int
        lib.wavio_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.wavio_read_batch.restype = None
        lib.wavio_read_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.wavio_read_batch_i16.restype = None
        lib.wavio_read_batch_i16.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str, max_samples: int) -> np.ndarray:
    lib = _load()
    assert lib is not None
    out = np.zeros((max_samples,), np.float32)
    sr = ctypes.c_int(0)
    n = lib.wavio_read(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_samples,
        ctypes.byref(sr),
    )
    if n < 0:
        raise IOError(f"wavio_read({path}) failed with code {n}")
    return out[:n]


def read_wav_batch(
    paths: List[str],
    stride: int,
    num_threads: int = 8,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Decode ``paths`` into a zero-padded (len(paths), stride) float32
    batch with a worker pool. Returns (batch, lengths)."""
    lib = _load()
    assert lib is not None
    n = len(paths)
    if out is None:
        out = np.empty((n, stride), np.float32)
    lengths = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.wavio_read_batch(
        c_paths,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    bad = np.where(lengths < 0)[0]
    if bad.size:
        raise IOError(
            f"wavio_read_batch failed for {[paths[i] for i in bad[:3]]} "
            f"(codes {lengths[bad[:3]].tolist()})"
        )
    return out, lengths


def read_wav_batch_i16(
    paths: List[str],
    stride: int,
    num_threads: int = 8,
    out: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Raw PCM16 batch decode into a zero-padded (len(paths), stride) int16
    batch — half the bytes of the float path; the device scales by 1/32768
    (``features.parse_batch``). Returns (batch, lengths)."""
    lib = _load()
    assert lib is not None
    n = len(paths)
    if out is None:
        out = np.empty((n, stride), np.int16)
    lengths = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.wavio_read_batch_i16(
        c_paths,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        num_threads,
    )
    bad = np.where(lengths < 0)[0]
    if bad.size:
        raise IOError(
            f"wavio_read_batch_i16 failed for {[paths[i] for i in bad[:3]]} "
            f"(codes {lengths[bad[:3]].tolist()})"
        )
    return out, lengths
