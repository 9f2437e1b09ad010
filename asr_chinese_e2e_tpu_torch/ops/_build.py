"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources (with the shared ``csrc/*.cuh`` headers)
compile with ``nvcc`` and no PyTorch headers, one ``nvcc`` process per
source, all started together, then link into one shared library with a
plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags, so a fresh checkout builds it at
first use and an edited source rebuilds it. Nothing here runs at import
time, and nothing falls back: a missing ``nvcc`` or a failed build raises.
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
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "asr_fbank": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "asr_attention_fwd": [
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _U, _U, _F,
        _I, _I, _I, _P,
    ],
    "asr_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
        _I, _F, _U, _U, _F, _I, _I, _I, _P,
    ],
    "asr_banded_attention_fwd": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _U, _F, _I, _I, _I, _P,
    ],
    "asr_banded_attention_bwd": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _U, _U,
        _F, _I, _I, _I, _P,
    ],
    "asr_ctc_alpha": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "asr_ctc_beta": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ],
}
# the scalar-FMA build of the bf16 attention kernels, which the package never
# calls: same arguments as the entry points they were, for side-by-side timing
SIGNATURES["asr_attention_fwd_fma"] = SIGNATURES["asr_attention_fwd"]
SIGNATURES["asr_attention_bwd_fma"] = SIGNATURES["asr_attention_bwd"]


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


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


def build() -> Path:
    """Compile the library if it is not on disk yet; returns its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # objects and the library go to temp names, and the library is renamed
    # into place, so a concurrent build never loads a half-written file
    with tempfile.TemporaryDirectory(dir=path.parent) as tmpdir:
        objs = [str(Path(tmpdir) / (src.stem + ".o")) for src in _sources()]
        _run([
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            for src, obj in zip(_sources(), objs)
        ])
        lib = str(Path(tmpdir) / LIB_NAME)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, path)
    return path


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with argtypes set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
