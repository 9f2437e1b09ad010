"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources (with the shared ``csrc/*.cuh`` headers)
compile with ``nvcc`` and no PyTorch headers, one ``nvcc`` process per
source, all started together, then link into one shared library with a
plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so a fresh checkout builds it at
first use and an edited source rebuilds it. Nothing here runs at import
time, and nothing falls back: a missing ``nvcc`` or a failed build raises.

A variant is a second library built the same way from the sources of
``csrc/<variant>/`` alone (which may include the shared sources), into
``build/kernels/<hash>-<variant>/``, and loaded by ``load_library(variant)``
on its first use: ``relpos`` holds the relative-position attention kernels
K11/K12, which only a model with relative positions compiles and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libasr_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_int64
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "asr_fbank": [_P, _I, _I, _I, _I, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "asr_attention_fwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _U, _U, _F,
        _I, _I, _I, _P,
    ],
    "asr_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _F, _U, _U, _F, _I, _I, _I, _P,
    ],
    "asr_banded_attention_fwd": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _U, _F, _I, _I, _I, _P,
    ],
    "asr_banded_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _U,
        _F, _I, _I, _I, _P,
    ],
    "asr_ctc_alpha": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "asr_ctc_beta": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
    "asr_ctc_prefix_registers": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    "asr_ctc_prefix_beam": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "asr_hash_dropout": [_P, _P, _L, _I, _L, _U, _U, _U, _U, _F, _P],
}
# the entry points of each variant library
VARIANT_SIGNATURES = {
    "relpos": {
        "asr_relpos_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "asr_relpos_attention_bwd": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
        ],
    },
}


def _sources(variant: str = "") -> list[Path]:
    return sorted((CSRC / variant if variant else CSRC).glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_name(variant: str) -> str:
    return f"libasr_{variant}_kernels.so" if variant else LIB_NAME


def library_path(variant: str = "") -> Path:
    """Where the library (or the ``variant`` library) of these sources
    lives; a variant is keyed by the shared sources too, which it
    includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    own = _sources(variant) if variant else []
    for src in _sources() + _headers() + own:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    key = h.hexdigest()[:16] + (f"-{variant}" if variant else "")
    return BUILD_ROOT / key / _lib_name(variant)


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of the first
    that failed."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    done = []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        done.append(subprocess.CompletedProcess(cmd, proc.returncode, out, err))
    for res in done:
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(res.args)}\n"
                f"{res.stdout}\n{res.stderr}"
            )


def build(variant: str = "") -> Path:
    """Compile the library (or the ``variant`` library) if it is not on
    disk yet; returns its path."""
    path = library_path(variant)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = _sources(variant)
    # objects and the library go to temp names, and the library is renamed
    # into place, so a concurrent build never loads a half-written file
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        objs = [str(Path(tmpdir) / (src.stem + ".o")) for src in sources]
        _run([
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            for src, obj in zip(sources, objs)
        ])
        lib = str(Path(tmpdir) / _lib_name(variant))
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=None)
def load_library(variant: str = "") -> ctypes.CDLL:
    """Build (if needed) and load the kernel library (or the ``variant``
    library), with argtypes set."""
    lib = ctypes.CDLL(str(build(variant)))
    for name, argtypes in (VARIANT_SIGNATURES[variant] if variant else SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
