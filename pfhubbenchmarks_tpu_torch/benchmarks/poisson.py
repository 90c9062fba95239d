"""Poisson validation problem: the reference's linear-solver ground truth
(dolfinx/poisson.py:47-121) as a runnable benchmark.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/poisson.py``, configuration
verbatim. Manufactured solution u = sin(pi x) sin(2 pi y) on [0, 1]^2 with
homogeneous Dirichlet sides; one Newton solve (the problem is linear).
Observables: the L2 error against the exact solution and the energy norm,
a live convergence check of assembly, BCs and Krylov (``--nx`` studies the
order).

It runs the f64 Krylov branch (``mixed_precision=False``, solve/newton.py):
J.v by ``torch.func.jvp`` of the f64 residual, f64 FGMRES, the f64
block-Jacobi of ``torch.func.jvp`` of the terms (solve/precond.py). The JAX
package runs all of it in XLA, so no kernel is on this path.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.poisson``.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.models import forms


def u_exact(x, y):
    return np.sin(np.pi * x) * np.sin(2 * np.pi * y)


def make(nx: int = 64, ny: int = 64, Lx: float = 1.0, Ly: float = 1.0,
         pad_to: tuple = (1, 1), **overrides) -> BenchmarkProblem:
    def terms(ctx):
        f = (-5.0 * np.pi**2 * torch.sin(torch.pi * ctx.x)
             * torch.sin(2 * torch.pi * ctx.y))
        s, fl = forms.poisson(ctx.du[0], f, 1.0)
        return [s], [fl]

    def l2_error_density(ctx):
        ue = torch.sin(torch.pi * ctx.x) * torch.sin(2 * torch.pi * ctx.y)
        return (ctx.u[0] - ue) ** 2

    def energy_density(ctx):
        du = ctx.du[0]
        return 0.5 * (du[0] ** 2 + du[1] ** 2)

    def zero(c):
        return 0.0 * c

    return BenchmarkProblem(
        name="poisson",
        grid=CrossedTriGrid(nx, ny, Lx, Ly, pad_to=pad_to),
        field_names=("u",),
        terms=terms,
        ic_fns=[lambda x, y: 0.0 * x],
        observables={
            "l2_error_sq": l2_error_density,
            "energy": energy_density,
        },
        csv_columns=("time", "l2_error_sq", "energy"),
        time=TimeConfig(t0=0.0, dt0=1.0, end_time=0.5, dt_min=1.0),
        solver=SolverConfig(line_search="basic", newton_atol=1e-10,
                            krylov_rtol=1e-9, mixed_precision=False,
                            precond="block_jacobi", krylov_max_iters=4000),
        dirichlet_spec=tuple((0, side, zero)
                             for side in ("left", "right", "top", "bottom")),
        needs_coords=True,
        **overrides,
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("poisson")
