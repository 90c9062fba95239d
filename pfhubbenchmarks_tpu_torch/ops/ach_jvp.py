"""Kernel G (``csrc/ach_jvp.cu``): J.v of BM3's Allen-Cahn + heat weak form
(fields U, phi; no anisotropy).

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` at
BM3's physics (the outer Krylov J.v and the exported A z, on the 350^2
ffc3 grid) and the in-kernel A.z of ``ops/pallas_vcycle.py:
make_fused_descend`` and ``make_fused_ascend`` (the dunavant2 levels). The
wrapper, its plain version (benchmarks/bench3.py's hand-written tangent,
which ``ACH::tangent`` mirrors, assembled in f32) and the parameter block
are ops/fem_jvp.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("D", "W0_sq", "inv_tau0", "lam")


def make_ach_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                 device: torch.device | str, dirichlet=()):
    """Returns ``jv(w, w0, dt, v, b=None)`` (ops/fem_jvp.make_fem_jvp) for
    the 2-field (U, phi) system; ``tangent`` is bench3's ``terms_tangent``."""
    return make_fem_jvp(grid, tangent, 2, name="ach_jvp", symbol="pfh_ach_jvp",
                        constants=tuple(constants[k] for k in CONSTANTS),
                        device=device, dirichlet=dirichlet)
