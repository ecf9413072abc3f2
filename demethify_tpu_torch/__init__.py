"""DeMethify on PyTorch and CUDA: the partial-reference solve for an
NVIDIA Hopper GPU.

A port of the JAX package ``demethify_tpu`` (which stays the reference the
port is tested against). Module names mirror the JAX package; the two
Pallas kernels of the main path are hand-written CUDA C++ under ``csrc/``
(see ``ops/cuda_kernels.py`` and ``ops/cuda_small.py``). This package
imports ``torch`` and never ``jax``.
"""

from demethify_tpu_torch import device  # noqa: F401  (sets the TF32 policy)
