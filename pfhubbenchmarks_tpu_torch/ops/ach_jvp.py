"""Kernel G (``csrc/ach_jvp.cu``): J.v of BM3's Allen-Cahn + heat weak form
(fields U, phi; no anisotropy); and BM3's forms of the tile kernels T10,
T12, TS (``csrc/ach_tile.cu``, ops/fem_tile.py) and of kernel W
(``csrc/ach_box.cu``, ops/tri_box.py: triangle boxes, bench3's outer J.v and
exported A z at ffc3).

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
from pfhubbenchmarks_tpu_torch.ops.fem_tile import make_tile_jvp
from pfhubbenchmarks_tpu_torch.ops.tri_box import make_box_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("D", "W0_sq", "inv_tau0", "lam")


def make_ach_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                 device: torch.device | str, dirichlet=(), form="gather"):
    """Returns ``jv(w, w0, dt, v, b=None)`` for the 2-field (U, phi) system:
    kernel G (ops/fem_jvp.make_fem_jvp) for ``form`` "gather", kernel W over
    G's launch record (ops/tri_box.make_box_jvp; a 4-point rule) for "box",
    else the tile kernel of that form (ops/fem_tile.make_tile_jvp);
    ``tangent`` is bench3's ``terms_tangent``."""
    k = tuple(constants[n] for n in CONSTANTS)
    if form not in ("gather", "box"):
        return make_tile_jvp(grid, tangent, 2, form=form, symbol="pfh_ach_tile",
                             constants=k, device=device, dirichlet=dirichlet)
    jv = make_fem_jvp(grid, tangent, 2, name="ach_jvp", symbol="pfh_ach_jvp",
                      constants=k, device=device, dirichlet=dirichlet)
    return make_box_jvp(jv) if form == "box" else jv
