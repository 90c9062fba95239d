"""Linear-elasticity cantilever (the reference's solver-validation demo).

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/elast.py``, configuration
verbatim. Reference: dolfin/elast.py: a 25 x 1 domain on a 250 x 10 crossed
mesh (:17-21), E = 1e5, nu = 0.3 plane-strain Lame parameters (:37-41), the
gravity load f = (0, -1e-3) (:43-44), the left edge clamped (:47-52). A
steady linear problem: one Newton solve. Vector-valued P1 fields
(displacement (ux, uy)) whose fluxes couple through the symmetric gradient.
Its committed row is ``results/elast_out.csv`` (t = 1.0).

The solver is the JAX package's: the whole Jacobian's row-equilibrated
inverse (``precond='dense'``, solve/precond.make_dense_precond) as the
preconditioner of an f64 FGMRES(50) (``mixed_precision=False``), built once
per solve (``precond_lag='solve'``; the problem is linear). The thin beam is
compliance-dominated, so smoother-based V-cycles stall in the residual norm
(the reference's SOR did too, dolfin/elast.py:83) and an f32 Krylov solve
floors far above the target. The JAX package runs all of it in XLA, so no
kernel is on this path: J.v by ``torch.func.jvp`` of the f64 residual, the
factor by ``torch.linalg.lu_factor`` in f64.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.elast``.
"""

from __future__ import annotations

import dataclasses

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.fem.sample import eval_at_points


@dataclasses.dataclass(frozen=True)
class ElastParams:
    E: float = 1e5
    nu: float = 0.3
    rho_g: float = 1e-3

    @property
    def mu(self) -> float:
        return self.E / 2.0 / (1.0 + self.nu)

    @property
    def lmda(self) -> float:
        return self.E * self.nu / (1.0 + self.nu) / (1.0 - 2.0 * self.nu)


def make(nx: int = 250, ny: int = 10, Lx: float = 25.0, Ly: float = 1.0,
         params: ElastParams = ElastParams(), pad_to: tuple = (1, 1),
         **overrides) -> BenchmarkProblem:
    p = params
    mu, lmda = p.mu, p.lmda

    def stress(dux, duy):
        exx = dux[0]
        eyy = duy[1]
        exy = 0.5 * (dux[1] + duy[0])
        tr_e = exx + eyy
        sxx = lmda * tr_e + 2.0 * mu * exx
        syy = lmda * tr_e + 2.0 * mu * eyy
        sxy = 2.0 * mu * exy
        return sxx, syy, sxy

    def terms(ctx):
        dux, duy = ctx.du
        sxx, syy, sxy = stress(dux, duy)
        # F = int sigma(u):eps(u_) - f . u_  (dolfin/elast.py:65)
        src = [0.0, p.rho_g]
        flux = [(sxx, sxy), (sxy, syy)]
        return src, flux

    def strain_energy(ctx):
        dux, duy = ctx.du
        sxx, syy, sxy = stress(dux, duy)
        exx, eyy = dux[0], duy[1]
        exy = 0.5 * (dux[1] + duy[0])
        return 0.5 * (sxx * exx + syy * eyy + 2.0 * sxy * exy)

    grid = CrossedTriGrid(nx, ny, Lx, Ly, pad_to=pad_to)

    def tip_deflection(w):
        """u_y at the free end's midline (the reference plots 1e3 u,
        dolfin/elast.py:126)."""
        return eval_at_points(grid, w, Lx, Ly / 2.0)[1]

    return BenchmarkProblem(
        name="elast",
        grid=grid,
        field_names=("ux", "uy"),
        terms=terms,
        ic_fns=[lambda x, y: 0.0 * x, lambda x, y: 0.0 * x],
        observables={"strain_energy": strain_energy},
        custom_observables={"tip_deflection": tip_deflection},
        csv_columns=("time", "strain_energy", "tip_deflection"),
        time=TimeConfig(t0=0.0, dt0=1.0, end_time=0.5, dt_min=1.0),
        solver=SolverConfig(line_search="basic", newton_max_iters=4,
                            precond="dense", krylov="fgmres",
                            mixed_precision=False, krylov_rtol=1e-8,
                            krylov_max_iters=100, gmres_restart=50,
                            precond_lag="solve", dense_refine_iters=0),
        dirichlet_spec=(
            (0, "left", lambda y: 0.0 * y),
            (1, "left", lambda y: 0.0 * y),
        ),
        **overrides,
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("elast")
