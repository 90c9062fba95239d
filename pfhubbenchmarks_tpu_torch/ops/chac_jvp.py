"""Kernel F (``csrc/chac_jvp.cu``): J.v of BM2's Cahn-Hilliard + Allen-Cahn
weak form, fields (c, mu, eta_1..eta_NE) with NE in {1, 2, 4}.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` at
BM2's physics and the in-kernel A.z of the sweep kernels
(``make_pallas_lmr_sweep_loop``, ``make_pallas_lmr_sweep``,
``ops/pallas_tiled.py:make_tiled_lmr_sweep``) and of
``ops/pallas_vcycle.py:make_fused_vcycle``. ``split=False`` is the coupled
operator (the tangent of ``terms``: the outer J.v and the exported A z);
``split=True`` the field-split one (the tangent of ``terms_precond``, block
diagonal by the groups (c, mu), eta_1, .., eta_NE: every multigrid level).
The wrapper, its plain version (the benchmark's hand-written pointwise
tangent, which ``CHAC::tangent`` mirrors, assembled in f32 by
fem/assembly.make_tangent_jvp) and the parameter block are
ops/fem_jvp.py's. BM2's forms of the tile kernels T10, T12, TS
(``csrc/chac_tile.cu``, ops/fem_tile.py; 4 order parameters, the coupled
operator at ffc3 and the split one at dunavant1), of kernel W
(``csrc/chac_box.cu``, ops/tri_box.py: the coupled operator at ffc3 over
triangle boxes, bench2's outer J.v), of the residual R
(``csrc/chac_residual.cu``, ops/fem_residual.py) and of the residual box
(``csrc/chac_rbox.cu``, ops/residual_box.py: bench2's cp line search) are
here too.
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
CONSTANTS = ("rho2", "c_alpha", "c_beta", "kappa_c", "kappa_eta", "M", "w",
             "alpha", "L")
NUM_ETA = (1, 2, 4)


def make_chac_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                  num_eta: int, split: bool, device: torch.device | str,
                  dirichlet=(), form="gather"):
    """Returns ``jv(w, w0, dt, v, b=None)`` for the (2 + num_eta)-field
    system: kernel F (ops/fem_jvp.make_fem_jvp) for ``form`` "gather",
    kernel W over F's launch record (ops/tri_box.make_box_jvp; the coupled
    operator at a 4-point rule) for "box", else the tile kernel of that form
    (ops/fem_tile.make_tile_jvp); ``tangent`` must be the one the kernel
    variant computes (bench2's ``make_terms_tangent(p, num_eta, split)``)."""
    if num_eta not in NUM_ETA:
        raise ValueError(f"chac_jvp is built for num_eta in {NUM_ETA}, "
                         f"got {num_eta}")
    k = tuple(constants[n] for n in CONSTANTS)
    if form not in ("gather", "box"):
        return make_tile_jvp(grid, tangent, 2 + num_eta, form=form,
                             symbol="pfh_chac_tile", constants=k,
                             device=device, dirichlet=dirichlet,
                             variant=(num_eta, int(split)))
    jv = make_fem_jvp(grid, tangent, 2 + num_eta, name="chac_jvp",
                      symbol="pfh_chac_jvp", constants=k, device=device,
                      dirichlet=dirichlet, variant=(num_eta, int(split)))
    return make_box_jvp(jv) if form == "box" else jv


def make_chac_residual(grid: CrossedTriGrid, terms, constants: dict, *,
                       num_eta: int, device: torch.device | str, dirichlet=(),
                       form="gather"):
    """Returns ``res(w, w0, dt)`` for the (2 + num_eta)-field system: kernel
    R (ops/fem_residual.make_fem_residual) for ``form`` "gather", the
    residual box over R's launch record (ops/residual_box.make_box_residual;
    a 4-point rule) for "box"; ``terms`` is bench2's coupled one."""
    if num_eta not in NUM_ETA:
        raise ValueError(f"chac_residual is built for num_eta in {NUM_ETA}, "
                         f"got {num_eta}")
    res = make_fem_residual(grid, terms, 2 + num_eta,
                            symbol="pfh_chac_residual",
                            constants=tuple(constants[n] for n in CONSTANTS),
                            device=device, dirichlet=dirichlet,
                            variant=(num_eta,))
    return make_box_residual(res) if form == "box" else res
