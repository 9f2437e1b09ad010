"""The plain reference of the benchmarked system: float32 PyTorch with TF32
off, no kernels, no cache, no batching tricks. It imports nothing of the
program and nothing of the JAX package; it takes from the benchmark the
inputs (int16 waves, labels, seeds) and the weights, and works out again
everything the program derives from them.

``Precision`` rounds the operands of every matrix product; the control of
``correct`` runs the reference with ``Precision("fp8")`` in the program's
place."""
