"""Kernel E (``csrc/chp_jvp.cu``): J.v of BM6's Cahn-Hilliard + Poisson
weak form, with the Dirichlet rows of phi as identity rows; its box form,
kernel W at BM6's physics (``csrc/chp_box.cu``, ops/tri_box.py: the
triangle box with the Dirichlet rows in its store, E's bits; bench6's outer
J.v); and BM6's forms
of the residual R (``csrc/chp_residual.cu``, ops/fem_residual.py) and of
the residual box (``csrc/chp_rbox.cu``, ops/residual_box.py: bench6's cp
line search), whose Dirichlet rows are u - g.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` at
BM6's physics (the outer Krylov J.v, whose BC rows the JAX package re-sets
after the kernel, ``benchmarks/base.py:201-215``) and the in-kernel masked
A.z of ``ops/pallas_vcycle.py:make_fused_descend_chain`` and
``make_fused_ascend_chain``; E stays the gather of every multigrid level
(inside kernel L and the chains) and the box's comparison. The wrapper, its
plain version
(benchmarks/bench6.py's hand-written tangent, which ``CHP::tangent``
mirrors, assembled in f32 with the BC rows) and the parameter block are
ops/fem_jvp.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp
from pfhubbenchmarks_tpu_torch.ops.fem_residual import make_fem_residual
from pfhubbenchmarks_tpu_torch.ops.residual_box import make_box_residual
from pfhubbenchmarks_tpu_torch.ops.tri_box import make_box_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("M", "kappa", "rho", "c_alpha", "c_beta", "k", "epsilon")


def make_chp_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                 device: torch.device | str, dirichlet=(), form="gather"):
    """Returns ``jv(w, w0, dt, v, b=None)`` for the 3-field (c, mu, phi)
    system: kernel E (ops/fem_jvp.make_fem_jvp) for ``form`` "gather",
    kernel W over E's launch record, Dirichlet mask included
    (ops/tri_box.make_box_jvp; a 4-point rule), for "box"; ``tangent`` is
    bench6's ``terms_tangent``."""
    jv = make_fem_jvp(grid, tangent, 3, name="chp_jvp", symbol="pfh_chp_jvp",
                      constants=tuple(constants[k] for k in CONSTANTS),
                      device=device, dirichlet=dirichlet)
    return make_box_jvp(jv) if form == "box" else jv


def make_chp_residual(grid: CrossedTriGrid, terms, constants: dict, *,
                      device: torch.device | str, dirichlet=(), form="gather"):
    """Returns ``res(w, w0, dt)`` for the 3-field system: kernel R
    (ops/fem_residual.make_fem_residual) for ``form`` "gather", the
    residual box over R's launch record (ops/residual_box.make_box_residual)
    for "box"; ``terms`` is bench6's."""
    res = make_fem_residual(grid, terms, 3, symbol="pfh_chp_residual",
                            constants=tuple(constants[k] for k in CONSTANTS),
                            device=device, dirichlet=dirichlet)
    return make_box_residual(res) if form == "box" else res
