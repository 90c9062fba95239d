"""PFHub Benchmark 1: 2D spinodal decomposition (mixed Cahn-Hilliard).

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench1.py``. Reference:
dolfin/bench1.py — 200x200 domain, 100x100 crossed mesh, no-flux BCs,
c_alpha=0.3, c_beta=0.7, rho_s=5, kappa=2, M=5 (:21-36), IC
pfbase.py:177-193, f_chem = rho_s (c-c_a)^2 (c_b-c)^2 (:63-65), adaptive
implicit Euler dt0=0.1, dt_min=1e-2, end_time=1e3 (:136-141). The solver
configuration is the JAX package's, whose comments record the measurements
behind each setting.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench1 --device cuda``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.models import forms


@dataclasses.dataclass(frozen=True)
class Bench1Params:
    c_alpha: float = 0.3
    c_beta: float = 0.7
    rho_s: float = 5.0
    kappa: float = 2.0
    M: float = 5.0
    c0: float = 0.5
    epsilon: float = 0.05


def ic_c(p: Bench1Params):
    """IC expression, pfbase.py:187-189 (evaluated at every P1 node)."""

    def fn(x, y):
        return p.c0 + p.epsilon * (
            np.cos(0.105 * x) * np.cos(0.11 * y)
            + (np.cos(0.13 * x) * np.cos(0.087 * y)) ** 2
            + np.cos(0.025 * x - 0.15 * y) * np.cos(0.07 * x - 0.02 * y)
        )

    return fn


def make_terms(p: Bench1Params):
    """(terms, terms_tangent, dfdc, f_chem) of BM1's weak form."""

    def dfdc(c):
        return 2.0 * p.rho_s * (c - p.c_alpha) * (p.c_beta - c) * (
            (p.c_beta - c) - (c - p.c_alpha))

    def d2fdc2(c):
        a, b = c - p.c_alpha, p.c_beta - c
        return 2.0 * p.rho_s * ((b - a) * (b - a) - 2.0 * a * b)

    def f_chem(c):
        return p.rho_s * (c - p.c_alpha) ** 2 * (p.c_beta - c) ** 2

    def terms(ctx):
        c, mu = ctx.u
        (sc, fc), (smu, fmu) = forms.cahn_hilliard(
            c, mu, ctx.du[1], ctx.du[0], ctx.u0[0], ctx.dt, p.M, p.kappa, dfdc(c))
        return [sc, smu], [fc, fmu]

    def terms_tangent(ctx, tctx):
        """Pointwise tangent of ``terms`` at ``ctx`` in the direction of
        ``tctx`` (its ``u``/``du`` hold the field tangents), written by
        hand; kernel A's ``ch_tangent`` (csrc/ch_jvp.cu) mirrors it:

            d src_c  = dc / dt            d flux_c  = M grad(dmu)
            d src_mu = dmu - f''(c) dc    d flux_mu = -kappa grad(dc)
        """
        c = ctx.u[0]
        dc, dmu = tctx.u
        gdc, gdmu = tctx.du
        src_c = dc / ctx.dt
        flux_c = tuple(p.M * d for d in gdmu)
        src_mu = dmu - d2fdc2(c) * dc
        flux_mu = tuple(-p.kappa * d for d in gdc)
        return [src_c, src_mu], [flux_c, flux_mu]

    return terms, terms_tangent, dfdc, f_chem


def kernel_constants(p: Bench1Params) -> dict:
    return dict(M=p.M, kappa=p.kappa, rho_s=p.rho_s, c_alpha=p.c_alpha,
                c_beta=p.c_beta)


def make(nx: int = 100, ny: int = 100, Lx: float = 200.0, Ly: float = 200.0,
         params: Bench1Params = Bench1Params(), **overrides) -> BenchmarkProblem:
    p = params
    terms, terms_tangent, _, f_chem = make_terms(p)

    def tfe_density(ctx):
        c = ctx.u[0]
        dc = ctx.du[0]
        return f_chem(c) + p.kappa / 2.0 * (dc[0] ** 2 + dc[1] ** 2)

    def kernel_jvp(grid, device, dirichlet=(), split=False, form="gather"):
        if split:
            raise NotImplementedError("bench1 has no field-split operator")
        from pfhubbenchmarks_tpu_torch.ops.ch_jvp import make_ch_jvp

        return make_ch_jvp(grid, terms_tangent, kernel_constants(p),
                           device=device, dirichlet=dirichlet, form=form)

    def kernel_residual(grid, device, dirichlet=(), form="gather"):
        from pfhubbenchmarks_tpu_torch.ops.ch_jvp import make_ch_residual

        return make_ch_residual(grid, terms, kernel_constants(p),
                                device=device, dirichlet=dirichlet, form=form)

    def kernel_phys():
        from pfhubbenchmarks_tpu_torch.ops.ch_jvp import CONSTANTS
        from pfhubbenchmarks_tpu_torch.ops.fem_jvp import KernelPhys

        k = kernel_constants(p)
        return KernelPhys("ch", terms_tangent, tuple(k[n] for n in CONSTANTS))

    return BenchmarkProblem(
        name="bench1",
        grid=CrossedTriGrid(nx, ny, Lx, Ly),
        field_names=("c", "mu"),
        terms=terms,
        ic_fns=[ic_c(p), lambda x, y: 0.0],
        observables={
            "total_free_energy": tfe_density,
            "total_solute": lambda ctx: ctx.u[0],
        },
        csv_columns=("time", "total_free_energy", "total_solute"),
        kernel_jvp=kernel_jvp,
        kernel_phys=kernel_phys,
        kernel_residual=kernel_residual,
        outer_jvp_form="box",
        **{"time": TimeConfig(dt0=1e-1, dt_min=1e-2, end_time=1e3,
                              grow_threshold=5),
           "solver": SolverConfig(line_search="basic", report_atol=2.6e-5,
                                  gmg_nu_pre=3, gmg_nu_post=3,
                                  gmg_nu_fine_pre=1,
                                  precond_rule="dunavant2",
                                  krylov_atol_frac=0.1,
                                  gmg_coarse_sweeps=8,
                                  gmg_min_cells=13,
                                  newton_stall_abort=6,
                                  krylov_forcing="ew", ew_eta0=0.1,
                                  ew_eta_max=0.3, ew_dt_min=5.0),
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench1")
