"""Kernel G (``csrc/ach_jvp.cu``): J.v of BM3's Allen-Cahn + heat weak form
(fields U, phi; no anisotropy); and BM3's forms of the tile kernels T10,
T12, TS (``csrc/ach_tile.cu``, ops/fem_tile.py) and of kernel W
(``csrc/ach_box.cu``, ops/tri_box.py: triangle boxes, bench3's outer J.v and
exported A z at ffc3).

The anisotropic BM3 (``bench3.make(anisotropy=True)``, the physics "acha",
``csrc/phys_acha.cuh``: a tangent that also reads the state's gradient) has
the gather form (``csrc/acha_jvp.cu``, the level J.v of its chains) and W
(``csrc/acha_box.cu``); its tile forms are not yet ported and refuse.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` at
BM3's physics (the outer Krylov J.v and the exported A z, on the 350^2
ffc3 grid) and the in-kernel A.z of ``ops/pallas_vcycle.py:
make_fused_descend`` and ``make_fused_ascend`` (the dunavant2 levels). The
wrapper, its plain version (benchmarks/bench3.py's hand-written tangent,
which ``ACH::tangent`` and ``ACHA::tangent`` mirror, assembled in f32) and
the parameter block are ops/fem_jvp.py's.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import make_fem_jvp
from pfhubbenchmarks_tpu_torch.ops.fem_tile import make_tile_jvp
from pfhubbenchmarks_tpu_torch.ops.tri_box import make_box_jvp

# physics constants each kernel takes, in its parameter order; "acha"
# begins with "ach"'s, so kernel N's "ach" instantiation reads its block
CONSTANTS = ("D", "W0_sq", "inv_tau0", "lam")
KIND_CONSTANTS = {"ach": CONSTANTS,
                  "acha": CONSTANTS + ("eps_m", "m", "cos_m_theta0",
                                       "sin_m_theta0")}


def constants_of(kind: str, constants: dict) -> tuple[float, ...]:
    """The constants of the physics ``kind`` in its kernels' order."""
    return tuple(constants[n] for n in KIND_CONSTANTS[kind])


def make_ach_jvp(grid: CrossedTriGrid, tangent, constants: dict, *,
                 device: torch.device | str, dirichlet=(), form="gather",
                 kind="ach"):
    """Returns ``jv(w, w0, dt, v, b=None)`` for the 2-field (U, phi) system:
    the gather kernel of ``kind`` (G for "ach", ``acha_jvp`` for "acha";
    ops/fem_jvp.make_fem_jvp) for ``form`` "gather", kernel W over its
    launch record (ops/tri_box.make_box_jvp; a 4-point rule) for "box", else
    the tile kernel of that form (ops/fem_tile.make_tile_jvp; "ach" only);
    ``tangent`` is bench3's ``terms_tangent`` of that physics."""
    k = constants_of(kind, constants)
    if form not in ("gather", "box"):
        if kind != "ach":
            raise NotImplementedError(
                f"the tile kernels (form {form!r}) at the physics {kind!r} "
                "are not yet ported")
        return make_tile_jvp(grid, tangent, 2, form=form, symbol="pfh_ach_tile",
                             constants=k, device=device, dirichlet=dirichlet)
    jv = make_fem_jvp(grid, tangent, 2, name=f"{kind}_jvp",
                      symbol=f"pfh_{kind}_jvp", constants=k, device=device,
                      dirichlet=dirichlet)
    return make_box_jvp(jv) if form == "box" else jv
