"""AISHELL-1 archive extraction (host-side, offline): a copy of the JAX
package's ``data/extract.py``, which imports no JAX.

Parity with ``data/extract_aishell1.py:7-20``: untar ``data_aishell.tgz``,
then untar each per-speaker inner ``.tar.gz`` and delete it.
"""

from __future__ import annotations

import os
import tarfile


def extract_aishell1(archive: str, out_dir: str, remove_inner: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    # filter="data" sanitises member paths (rejects absolute/.. escapes) —
    # also the forward-compatible default from Python 3.14
    with tarfile.open(archive) as tf:
        tf.extractall(out_dir, filter="data")
    root = os.path.join(out_dir, "data_aishell")
    wav_dir = os.path.join(root, "wav")
    for name in sorted(os.listdir(wav_dir)):
        if not (name.endswith(".tar.gz") or name.endswith(".tgz")):
            continue
        inner = os.path.join(wav_dir, name)
        with tarfile.open(inner) as tf:
            tf.extractall(wav_dir, filter="data")
        if remove_inner:
            os.remove(inner)
    return root
