"""Kernel A (``csrc/ch_jvp.cu``): J.v of BM1's Cahn-Hilliard weak form.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` and
the in-kernel A.z of ``ops/pallas_vcycle.py:make_fused_vcycle``. The wrapper,
its plain version (benchmarks/bench1.py's hand-written tangent, which
``CH::tangent`` mirrors, assembled in f32) and the parameter block are
ops/fem_jvp.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("M", "kappa", "rho_s", "c_alpha", "c_beta")


def make_ch_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                device: torch.device | str, dirichlet=()):
    """Returns ``jv(w, w0, dt, v, b=None)`` (ops/fem_jvp.make_fem_jvp) for
    the 2-field (c, mu) system; ``tangent`` is bench1's ``terms_tangent``."""
    return make_fem_jvp(grid, tangent, 2, name="ch_jvp", symbol="pfh_ch_jvp",
                        constants=tuple(constants[k] for k in CONSTANTS),
                        device=device, dirichlet=dirichlet)
