"""asr_chinese_e2e_tpu_torch — the PyTorch/CUDA port of ``asr_chinese_e2e_tpu``.

Mirrors the JAX package's module paths so each counterpart is easy to find.
Plain tensor code is PyTorch; each Pallas kernel of the JAX package on the
ported path is a CUDA C++ kernel for Hopper (``ops/csrc/``), built at first
use and bound with ``ctypes``. Importing this package imports neither jax
nor the JAX package.
"""

__version__ = "0.1.0"
