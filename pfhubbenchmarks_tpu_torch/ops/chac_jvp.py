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
ops/fem_jvp.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp

# physics constants the kernel takes, in its parameter order
CONSTANTS = ("rho2", "c_alpha", "c_beta", "kappa_c", "kappa_eta", "M", "w",
             "alpha", "L")
NUM_ETA = (1, 2, 4)


def make_chac_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                  num_eta: int, split: bool, device: torch.device | str,
                  dirichlet=()):
    """Returns ``jv(w, w0, dt, v, b=None)`` (ops/fem_jvp.make_fem_jvp) for
    the (2 + num_eta)-field system; ``tangent`` must be the one the kernel
    variant computes (bench2's ``make_terms_tangent(p, num_eta, split)``)."""
    if num_eta not in NUM_ETA:
        raise ValueError(f"chac_jvp is built for num_eta in {NUM_ETA}, "
                         f"got {num_eta}")
    return make_fem_jvp(grid, tangent, 2 + num_eta, name="chac_jvp",
                        symbol="pfh_chac_jvp",
                        constants=tuple(constants[k] for k in CONSTANTS),
                        device=device, dirichlet=dirichlet,
                        variant=(num_eta, int(split)))
