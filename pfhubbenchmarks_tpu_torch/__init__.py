"""PyTorch / CUDA port of the PFHub phase-field benchmark framework.

The counterpart of ``pfhubbenchmarks_tpu`` (the JAX package, kept as the
reference), with the same module layout. Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas for the TPU are hand-written CUDA
kernels for Hopper (``csrc/``, bound in ``ops/``), each with a plain
PyTorch version beside it. The package imports torch and numpy, never jax.
"""

__version__ = "0.1.0"

from pfhubbenchmarks_tpu_torch import config as config
from pfhubbenchmarks_tpu_torch.fem import quadrature as quadrature
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid as CrossedTriGrid
