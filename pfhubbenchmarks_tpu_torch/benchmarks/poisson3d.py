"""3D Poisson validation: the reference's 3D assembly ground truth
(dolfinx/poisson3d.py:59-121) as a runnable benchmark.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/poisson3d.py``, configuration
verbatim. Solves -lap(u) = f on the unit cube with homogeneous Dirichlet on
all six faces and the reference's forcing f = sin(2 pi x) sin(3 pi y)
sin(4 pi z) (dolfinx/poisson3d.py:90), a Laplace eigenfunction vanishing on
the boundary, so the exact solution is u = f / (29 pi^2). Observables: the
L2 error against it and the energy norm (``--nx/--ny/--nz`` study the
O(h^2) convergence).

It runs the f64 Krylov branch (``mixed_precision=False``): J.v by
``torch.func.jvp`` of the f64 residual, f64 FGMRES, the f64 3D block-Jacobi
of ``torch.func.jvp`` of the terms (``solve/precond.make_block_jacobi3d_terms``).
The JAX package runs all of it in XLA, so no kernel is on this path.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.poisson3d``.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import Benchmark3DProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.models import forms

_LAM = 29.0 * np.pi**2  # (2^2 + 3^2 + 4^2) pi^2


def u_exact(x, y, z):
    return (np.sin(2 * np.pi * x) * np.sin(3 * np.pi * y)
            * np.sin(4 * np.pi * z) / _LAM)


def make(nx: int = 32, ny: int = 32, nz: int = 32,
         Lx: float = 1.0, Ly: float = 1.0, Lz: float = 1.0,
         pad_to: tuple = (1, 1, 1), **overrides) -> Benchmark3DProblem:
    def f_ref(x, y, z):
        return (torch.sin(2 * torch.pi * x) * torch.sin(3 * torch.pi * y)
                * torch.sin(4 * torch.pi * z))

    def terms(ctx):
        # forms.poisson's residual is \int -f v - grad u . grad v, so the
        # weak form of -lap(u) = f_ref needs f = -f_ref
        s, fl = forms.poisson(ctx.du[0], -f_ref(ctx.x, ctx.y, ctx.z), 1.0)
        return [s], [fl]

    def l2_error_density(ctx):
        ue = f_ref(ctx.x, ctx.y, ctx.z) / _LAM
        return (ctx.u[0] - ue) ** 2

    def energy_density(ctx):
        du = ctx.du[0]
        return 0.5 * (du[0] ** 2 + du[1] ** 2 + du[2] ** 2)

    def zero(c1, c2):
        return 0.0 * c1

    return Benchmark3DProblem(
        name="poisson3d",
        grid=TetGrid(nx, ny, nz, Lx, Ly, Lz, pad_to=pad_to),
        field_names=("u",),
        terms=terms,
        ic_fns=[lambda x, y, z: 0.0 * x],
        observables={
            "l2_error_sq": l2_error_density,
            "energy": energy_density,
        },
        csv_columns=("time", "l2_error_sq", "energy"),
        time=TimeConfig(t0=0.0, dt0=1.0, end_time=0.5, dt_min=1.0),
        solver=SolverConfig(line_search="basic", newton_atol=1e-10,
                            krylov_rtol=1e-9, mixed_precision=False,
                            precond="block_jacobi", krylov_max_iters=4000),
        dirichlet_spec=tuple(
            (0, face, zero)
            for face in ("x0", "x1", "y0", "y1", "z0", "z1")),
        needs_coords=True,
        **overrides,
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("poisson3d")
