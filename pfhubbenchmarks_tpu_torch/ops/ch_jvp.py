"""Kernel A (``csrc/ch_jvp.cu``): J.v of BM1's Cahn-Hilliard weak form,
and BM1's forms of the tile kernels T10, T12, TS (``csrc/ch_tile.cu``), of
kernel W (``csrc/ch_box.cu``, ops/tri_box.py: triangle boxes, bench1's
outer J.v and exported A z at ffc3) and of the residual R
(``csrc/ch_residual.cu``).

Kernel A replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:
make_pallas_jvp`` and the in-kernel A.z of ``ops/pallas_vcycle.py:
make_fused_vcycle``. The wrappers, their plain versions (benchmarks/
bench1.py's hand-written tangent, which ``CH::tangent`` mirrors, assembled
in f32; the f32 assembly of its ``terms`` for R) and the parameter block
are ops/fem_jvp.py's, ops/fem_tile.py's and ops/fem_residual.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp
from pfhubbenchmarks_tpu_torch.ops.fem_residual import make_fem_residual
from pfhubbenchmarks_tpu_torch.ops.fem_tile import make_tile_jvp
from pfhubbenchmarks_tpu_torch.ops.residual_box import make_box_residual
from pfhubbenchmarks_tpu_torch.ops.tri_box import make_box_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("M", "kappa", "rho_s", "c_alpha", "c_beta")


def make_ch_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                device: torch.device | str, dirichlet=(), form="gather"):
    """Returns ``jv(w, w0, dt, v, b=None)`` for the 2-field (c, mu) system:
    kernel A (ops/fem_jvp.make_fem_jvp) for ``form`` "gather", kernel W
    over A's launch record (ops/tri_box.make_box_jvp; a 4-point rule, no
    Dirichlet rows) for "box", else the tile kernel of that form
    (ops/fem_tile.make_tile_jvp); ``tangent`` is bench1's
    ``terms_tangent``."""
    k = tuple(constants[n] for n in CONSTANTS)
    if form not in ("gather", "box"):
        return make_tile_jvp(grid, tangent, 2, form=form, symbol="pfh_ch_tile",
                             constants=k, device=device, dirichlet=dirichlet)
    jv = make_fem_jvp(grid, tangent, 2, name="ch_jvp", symbol="pfh_ch_jvp",
                      constants=k, device=device, dirichlet=dirichlet)
    return make_box_jvp(jv) if form == "box" else jv


def make_ch_residual(grid: CrossedTriGrid, terms, constants: dict, *,
                     device: torch.device | str, dirichlet=(), form="gather"):
    """Returns ``res(w, w0, dt)`` (ops/fem_residual.make_fem_residual) for
    the 2-field system; ``terms`` is bench1's. The residual box has no
    instantiation at BM1 (bench1's basic line search reads no f32
    residual), so ``form`` "box" is refused."""
    res = make_fem_residual(grid, terms, 2, symbol="pfh_ch_residual",
                            constants=tuple(constants[n] for n in CONSTANTS),
                            device=device, dirichlet=dirichlet)
    return make_box_residual(res) if form == "box" else res
