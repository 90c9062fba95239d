"""True 3D Benchmark 6: electrochemistry (Cahn-Hilliard + Poisson) on a box.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench6_3d.py``: BM6's physics
(dolfin/bench6.py:33-90) on a 50^3 Kuhn-tet box over 100^3, the 2D IC
applied z-invariantly (the b13d convention), and phi's Dirichlet data
extended z-invariantly: phi = 0 on the x = 0 face, phi = sin(y/7) on the
x = Lx face (``DirichletBC3D``, fem/assembly3d.py). The time and solver
configurations are the JAX package's verbatim: dt0 1e-2, dt_min 1e-4,
end_time 3, no dt_max; line search 'cp', at most 300 Krylov iterations, GMG
50^3 -> 25^3 -> 5^3 at ffc3 on every level (no ``precond_rule``), the exact
dense inverse on 5^3 (3 x 6^3 = 648 dofs, under the 1500 cap).

No reference golden data exists; the JAX package's own CPU run is the gate
(``tools/jax_bench6_3d_rows.py``, ``tests/data/bench6_3d_jax_rows*``). A
thin-z run does not reproduce bench6: z-invariant data does not give a
z-invariant discrete solution on Kuhn tets with mixed Dirichlet/Neumann
faces (tests/test_golden.py:125-134).

On a CUDA device the outer Krylov J.v and every level's ``b - A x`` are
kernel U at BM6's physics with the Dirichlet mask (``chp3d_tile``,
ops/fem_jvp3d.py), every level's sweeps kernel L's 3D form at that physics
(``lmr_loop_chp3d``, ops/lmr.py). The JAX package runs these on XLA (its
Pallas 3D kernels take no BC rows), so they replace no TPU kernel. The f64
residual, the f32 residual of the cp line search, the transfers, the block
build and the dense coarse Jacobian are plain torch, as for bench1_3d.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench6_3d``.
"""

from __future__ import annotations

import numpy as np

from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import Benchmark3DProblem
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import (Bench6Params, ic_c,
                                                         kernel_constants,
                                                         make_terms)
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid

# (field, face, fn(c1, c2)): x faces get (y, z); the z-invariant extension of
# bench6's edges (dolfin/bench6.py:77-90)
DIRICHLET_SPEC = (
    (2, "x0", lambda y, z: 0.0 * y),
    (2, "x1", lambda y, z: np.sin(y / 7.0)),
)


def make(nx: int = 50, ny: int = 50, nz: int = 50, Lx: float = 100.0,
         Ly: float = 100.0, Lz: float = 100.0,
         params: Bench6Params = Bench6Params(), pad_to: tuple = (1, 1, 1),
         **overrides) -> Benchmark3DProblem:
    p = params
    terms, terms_tangent, f_chem = make_terms(p)
    ic = ic_c(p)

    def tfe_density(ctx):
        c, _, phi = ctx.u
        dc = ctx.du[0]
        return (f_chem(c) + p.k * c * phi / 2.0
                + p.kappa / 2.0 * (dc[0] ** 2 + dc[1] ** 2 + dc[2] ** 2))

    def kernel_jvp(grid, device, dirichlet=()):
        from pfhubbenchmarks_tpu_torch.ops.fem_jvp3d import make_chp3d_jvp

        return make_chp3d_jvp(grid, terms_tangent, kernel_constants(p),
                              device=device, dirichlet=dirichlet)

    return Benchmark3DProblem(
        name="bench6_3d",
        grid=TetGrid(nx, ny, nz, Lx, Ly, Lz, pad_to=pad_to),
        field_names=("c", "mu", "phi"),
        terms=terms,
        terms_tangent=terms_tangent,
        ic_fns=[lambda x, y, z: ic(x, y), lambda x, y, z: 0.0 * x,
                lambda x, y, z: 0.0 * x],
        observables={
            "total_free_energy": tfe_density,
            "total_solute": lambda ctx: ctx.u[0],
        },
        csv_columns=("time", "total_free_energy", "total_solute"),
        kernel_jvp=kernel_jvp,
        **{"time": TimeConfig(dt0=1e-2, dt_min=1e-4, end_time=3.0,
                              grow_threshold=5),
           "solver": SolverConfig(line_search="cp", krylov_max_iters=300,
                                  precond="gmg"),
           "dirichlet_spec": DIRICHLET_SPEC,
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench6_3d")
