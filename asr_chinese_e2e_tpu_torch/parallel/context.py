"""The active mesh, as context for the layers that consult it
(``asr_chinese_e2e_tpu/parallel/context.py``).

The attention and dropout layers know nothing of processes. The trainer,
the distributed decode and the dry run set the mesh (``with
active_mesh(mesh): ...``) around a step, and the layers read it:
``MultiHeadAttention`` folds the rank's mesh coordinates into its
dropout seed and runs ring attention over ``seq``, and
``ConfigurableDropout(impl="hash")`` offsets its element index by the
rank's first row of the global batch. Nestable; ``None`` masks an outer
mesh.
"""

from __future__ import annotations

import contextlib
from typing import Optional

_ACTIVE: list = []


@contextlib.contextmanager
def active_mesh(mesh):
    """Set the mesh the layers shard over, for the body of the block."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def get_active_mesh() -> Optional[object]:
    return _ACTIVE[-1] if _ACTIVE else None
