"""PFHub Benchmark 6: electrochemistry, Cahn-Hilliard + Poisson coupling.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench6.py``. Reference:
dolfin/bench6.py — 100x100 domain, 100x100 crossed mesh (:22-24), fields
(c, mu, phi) (:44-46), kappa=2, rho=5, M=5, k=0.09, epsilon=90 (:33-39),
electromigration via dfdc = f_chem' + k phi (:68), Poisson source
-k c / epsilon (:72), Dirichlet BCs on phi only: phi=0 left, phi=sin(y/7)
right (:77-90), dt0=1e-2, dt_min=1e-4, end_time=3 (:177-181), line search
'cp' (:117). The time and solver configurations are the JAX package's,
whose comments record the measurements behind each setting (its dt_max
0.32 reproduces the committed 14-row reference grid).

``gmg_min_cells=25`` gives the hierarchy 100/50/25. Its 25^2 coarsest level
has 3 (26^2 + 25^2) = 3903 dofs, above the 3000-dof cap for a dense
inverse, so the coarsest level is solved by ``gmg_coarse_sweeps`` (24) LMR
sweeps, in the JAX package as here.

BM6's field-split preconditioner terms (``terms_precond``) are not ported:
``field_split`` is off for BM6 (BM2 runs it, benchmarks/bench2.py).

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench6 --device cuda``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.models import forms


@dataclasses.dataclass(frozen=True)
class Bench6Params:
    c_alpha: float = 0.3
    c_beta: float = 0.7
    kappa: float = 2.0
    rho: float = 5.0
    M: float = 5.0
    k: float = 0.09
    epsilon: float = 90.0
    cc0: float = 0.5
    cc1: float = 0.04


def ic_c(p: Bench6Params):
    """pfbase.py:332-334 (note the 0.2 frequency vs bench1's 0.105)."""

    def fn(x, y):
        return p.cc0 + p.cc1 * (
            np.cos(0.2 * x) * np.cos(0.11 * y)
            + (np.cos(0.13 * x) * np.cos(0.087 * y)) ** 2
            + np.cos(0.025 * x - 0.15 * y) * np.cos(0.07 * x - 0.02 * y)
        )

    return fn


# (field, side, fn(coord)): phi = 0 on the left edge, sin(y/7) on the right
DIRICHLET_SPEC = (
    (2, "left", lambda y: 0.0 * y),
    (2, "right", lambda y: np.sin(y / 7.0)),
)


def make_terms(p: Bench6Params):
    """(terms, terms_tangent, f_chem) of BM6's weak form."""

    def f_chem(c):
        return p.rho * (c - p.c_alpha) ** 2 * (p.c_beta - c) ** 2

    def dfdc_chem(c):
        return 2.0 * p.rho * (c - p.c_alpha) * (p.c_beta - c) * (
            (p.c_beta - c) - (c - p.c_alpha))

    def d2fdc2(c):
        a, b = c - p.c_alpha, p.c_beta - c
        return 2.0 * p.rho * ((b - a) * (b - a) - 2.0 * a * b)

    def terms(ctx):
        c, mu, phi = ctx.u
        (sc, fc), (smu, fmu) = forms.cahn_hilliard(
            c, mu, ctx.du[1], ctx.du[0], ctx.u0[0], ctx.dt, p.M, p.kappa,
            dfdc_chem(c) + p.k * phi)
        sp, fp = forms.poisson(ctx.du[2], -p.k * c / p.epsilon, 1.0)
        return [sc, smu, sp], [fc, fmu, fp]

    def terms_tangent(ctx, tctx):
        """Pointwise tangent of ``terms`` at ``ctx`` in the direction of
        ``tctx``, written by hand; kernel E's ``CHP::tangent``
        (csrc/chp_jvp.cu) mirrors it:

            d src_c   = dc / dt                   d flux_c   = M grad(dmu)
            d src_mu  = dmu - f''(c) dc - k dphi  d flux_mu  = -kappa grad(dc)
            d src_phi = k dc / epsilon            d flux_phi = -grad(dphi)
        """
        c = ctx.u[0]
        dc, dmu, dphi = tctx.u
        gdc, gdmu, gdphi = tctx.du
        src_c = dc / ctx.dt
        flux_c = tuple(p.M * d for d in gdmu)
        src_mu = dmu - d2fdc2(c) * dc - p.k * dphi
        flux_mu = tuple(-p.kappa * d for d in gdc)
        src_phi = p.k * dc / p.epsilon
        flux_phi = tuple(-d for d in gdphi)
        return [src_c, src_mu, src_phi], [flux_c, flux_mu, flux_phi]

    return terms, terms_tangent, f_chem


def kernel_constants(p: Bench6Params) -> dict:
    return dict(M=p.M, kappa=p.kappa, rho=p.rho, c_alpha=p.c_alpha,
                c_beta=p.c_beta, k=p.k, epsilon=p.epsilon)


def make(nx: int = 100, ny: int = 100, Lx: float = 100.0, Ly: float = 100.0,
         params: Bench6Params = Bench6Params(), **overrides) -> BenchmarkProblem:
    p = params
    terms, terms_tangent, f_chem = make_terms(p)

    def tfe_density(ctx):
        c, _, phi = ctx.u
        dc = ctx.du[0]
        return (f_chem(c) + p.k * c * phi / 2.0
                + p.kappa / 2.0 * (dc[0] ** 2 + dc[1] ** 2))

    def kernel_jvp(grid, device, dirichlet=(), split=False, form="gather"):
        if split:
            raise NotImplementedError("bench6 has no field-split operator")
        if form not in ("gather", "box"):
            raise NotImplementedError(
                "bench6 has no tile kernels (SolverConfig.tiled_grid_kernels "
                "is ported for bench1, bench2 and bench3)")
        from pfhubbenchmarks_tpu_torch.ops.chp_jvp import make_chp_jvp

        return make_chp_jvp(grid, terms_tangent, kernel_constants(p),
                            device=device, dirichlet=dirichlet, form=form)

    def kernel_residual(grid, device, dirichlet=(), form="gather"):
        from pfhubbenchmarks_tpu_torch.ops.chp_jvp import make_chp_residual

        return make_chp_residual(grid, terms, kernel_constants(p),
                                 device=device, dirichlet=dirichlet, form=form)

    return BenchmarkProblem(
        name="bench6",
        grid=CrossedTriGrid(nx, ny, Lx, Ly),
        field_names=("c", "mu", "phi"),
        terms=terms,
        ic_fns=[ic_c(p), lambda x, y: 0.0, lambda x, y: 0.0],
        observables={
            "total_free_energy": tfe_density,
            "total_solute": lambda ctx: ctx.u[0],
        },
        csv_columns=("time", "total_free_energy", "total_solute"),
        kernel_jvp=kernel_jvp,
        kernel_residual=kernel_residual,
        outer_jvp_form="box",
        residual_form="box",
        **{"time": TimeConfig(dt0=1e-2, dt_min=1e-4, end_time=3.0,
                              grow_threshold=5, dt_max=0.32),
           "solver": SolverConfig(line_search="cp", krylov_max_iters=300,
                                  fuse_vcycle="split_chain", gmg_min_cells=25,
                                  gmg_dense_coarse_max_dofs=3000,
                                  precond_lag="solve",
                                  precond_rule="dunavant2"),
           "dirichlet_spec": DIRICHLET_SPEC,
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench6")
