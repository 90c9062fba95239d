"""PFHub Benchmark 2: Ostwald ripening, Cahn-Hilliard + Allen-Cahn order
parameters.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench2.py``. Reference:
dolfin/bench2.py — 200x200 domain, 100x100 crossed mesh, six fields
(c, mu, eta1..eta4) (:45-52), rho = sqrt(2), kappa_c = kappa_eta = 3, M = 5,
w = 1, alpha = 5, L = 5 (:33-42), two-phase f_chem with the quintic
interpolant, four-well and pairwise penalty (:76-99), ICs pfbase.py:262-291,
dt0 = 1e-2, dt_min = 1e-4, end_time = 100 (:220-223), line search 'cp'
(:140). ``num_eta`` 1 and 2 are the reference's reduced variants
(dolfin/bench2_eta1.py, bench2_eta2.py; registry ``bench2_eta1/eta2``).

The time and solver configurations are the JAX package's, whose comments
record the measurements behind each setting: field split (``terms_precond``,
groups (c, mu), eta1, .., eta4) with per-group LMR step lengths, the
dunavant1 preconditioner rule, 8 coarse sweeps, stall abort 5, one fine
pre-sweep and FGMRES restart 16. The default ``gmg_min_cells`` 7 gives the
hierarchy 100/50/25; the 25^2 level has 6 (26^2 + 25^2) = 7806 dofs, above
the 1500-dof dense cap, so the coarsest level runs the 8 LMR sweeps.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench2 --device cuda``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.models import forms

NUM_ETA = 4


@dataclasses.dataclass(frozen=True)
class Bench2Params:
    c_alpha: float = 0.3
    c_beta: float = 0.7
    rho: float = math.sqrt(2.0)
    kappa_c: float = 3.0
    kappa_eta: float = 3.0
    M: float = 5.0
    w: float = 1.0
    alpha: float = 5.0
    L: float = 5.0
    c0: float = 0.5
    epsilon: float = 0.05
    epsilon_eta: float = 0.1
    psi: float = 1.5


def ic_c(p: Bench2Params):
    def fn(x, y):
        return p.c0 + p.epsilon * (
            np.cos(0.105 * x) * np.cos(0.11 * y)
            + (np.cos(0.13 * x) * np.cos(0.087 * y)) ** 2
            + np.cos(0.025 * x - 0.15 * y) * np.cos(0.07 * x - 0.02 * y)
        )

    return fn


def ic_eta(p: Bench2Params, i: int):
    """pfbase.py:279-288: the reference mixes ``ii = i + 1`` in the first two
    terms with plain ``i`` in the psi term; reproduced exactly."""
    ii = i + 1.0

    def fn(x, y):
        return p.epsilon_eta * (
            np.cos((0.01 * ii) * x - 4.0) * np.cos((0.007 + 0.01 * ii) * y)
            + np.cos((0.11 + 0.01 * ii) * x) * np.cos((0.11 + 0.01 * ii) * y)
            + p.psi * (
                np.cos((0.046 + 0.001 * i) * x - (0.0405 + 0.001 * i) * y)
                * np.cos((0.031 + 0.001 * i) * x - (0.004 + 0.001 * i) * y)
            ) ** 2
        ) ** 2

    return fn


def _hsum(etas):
    return sum(forms.h(e) for e in etas)


def make_f_chem(p: Bench2Params, num_eta: int = NUM_ETA):
    rho2 = p.rho ** 2

    def f_chem(c, etas):
        f_a = rho2 * (c - p.c_alpha) ** 2
        f_b = rho2 * (c - p.c_beta) ** 2
        H = _hsum(etas)
        dw = sum(e**2 * (1.0 - e) ** 2 for e in etas)
        pair = 0.0
        for i in range(num_eta):
            for j in range(i + 1, num_eta):
                pair = pair + etas[i] ** 2 * etas[j] ** 2
        return f_a * (1.0 - H) + f_b * H + p.w * (dw + p.alpha * pair)

    return f_chem


def make_terms(p: Bench2Params, num_eta: int = NUM_ETA, split: bool = False):
    """The pointwise weak form. ``split=True`` gives the field-split
    preconditioner's terms: the same values, with the cross-group couplings
    (the etas seen by the CH rows; c and the other etas seen by each AC row)
    detached, so every ``torch.func`` linearization of it is the block
    diagonal diag(J_CH, J_AC1, ..). ``.detach()`` stands for the JAX
    package's ``lax.stop_gradient``: ``torch.func.jvp`` gives it a zero
    tangent."""
    rho2 = p.rho ** 2
    sg = (lambda v: v.detach()) if split else (lambda v: v)

    def dfdc(c, etas):
        H = _hsum([sg(e) for e in etas])
        return 2.0 * rho2 * ((c - p.c_alpha) * (1.0 - H) + (c - p.c_beta) * H)

    def dfdeta(c, etas, i):
        cc = sg(c)
        f_a = rho2 * (cc - p.c_alpha) ** 2
        f_b = rho2 * (cc - p.c_beta) ** 2
        e = etas[i]
        others_sq = sum(sg(etas[j]) ** 2 for j in range(num_eta) if j != i)
        dwell = 2.0 * e * (1.0 - e) * (1.0 - 2.0 * e)
        return ((f_b - f_a) * forms.dh(e)
                + p.w * (dwell + 2.0 * p.alpha * e * others_sq))

    def terms(ctx):
        c, mu = ctx.u[0], ctx.u[1]
        etas = ctx.u[2:]
        (sc, fc), (smu, fmu) = forms.cahn_hilliard(
            c, mu, ctx.du[1], ctx.du[0], ctx.u0[0], ctx.dt, p.M, p.kappa_c,
            dfdc(c, etas))
        src, flux = [sc, smu], [fc, fmu]
        for i in range(num_eta):
            s_i, f_i = forms.allen_cahn(
                etas[i], ctx.du[2 + i], ctx.u0[2 + i], ctx.dt, p.L,
                p.kappa_eta, dfdeta(c, etas, i))
            src.append(s_i)
            flux.append(f_i)
        return src, flux

    return terms


def make_terms_tangent(p: Bench2Params, num_eta: int = NUM_ETA,
                       split: bool = False):
    """Pointwise tangent of ``make_terms(p, num_eta, split)`` at ``ctx`` in
    the direction of ``tctx`` (its ``u``/``du`` hold the field tangents),
    written by hand; kernel F's ``CHAC::tangent`` (csrc/chac_jvp.cu) mirrors
    it. With f_a = rho^2 (c - c_a)^2, f_b = rho^2 (c - c_b)^2 and
    dwell'(e) = 2 - 12 e + 12 e^2:

        d src_c   = dc / dt                d flux_c   = M grad(dmu)
        d src_mu  = dmu - 2 rho^2 (dc + (c_a - c_b) sum_i h'(e_i) de_i)
                                           d flux_mu  = -kappa_c grad(dc)
        d src_e_i = de_i / dt + L [2 rho^2 (c_a - c_b) h'(e_i) dc
                    + (f_b - f_a) h''(e_i) de_i + w (dwell'(e_i) de_i
                    + 2 alpha (sum_{j!=i} e_j^2 de_i + 2 e_i sum_{j!=i} e_j de_j))]
                                           d flux_e_i = L kappa_eta grad(de_i)

    ``split``: d src_mu = dmu - 2 rho^2 dc, and d src_e_i keeps only its
    de_i terms: de_i / dt + L [(f_b - f_a) h''(e_i) + w (dwell'(e_i)
    + 2 alpha sum_{j!=i} e_j^2)] de_i.
    """
    rho2 = p.rho ** 2

    def tangent(ctx, tctx):
        c, etas = ctx.u[0], ctx.u[2:]
        dc, dmu, detas = tctx.u[0], tctx.u[1], tctx.u[2:]
        gdc, gdmu = tctx.du[0], tctx.du[1]
        src_c = dc / ctx.dt
        flux_c = tuple(p.M * d for d in gdmu)
        if split:
            src_mu = dmu - 2.0 * rho2 * dc
        else:
            hd = sum(forms.dh(e) * de for e, de in zip(etas, detas))
            src_mu = dmu - 2.0 * rho2 * (dc + (p.c_alpha - p.c_beta) * hd)
        flux_mu = tuple(-p.kappa_c * d for d in gdc)
        src, flux = [src_c, src_mu], [flux_c, flux_mu]
        fba = rho2 * (c - p.c_beta) ** 2 - rho2 * (c - p.c_alpha) ** 2
        for i in range(num_eta):
            e, de = etas[i], detas[i]
            osq = sum(etas[j] ** 2 for j in range(num_eta) if j != i)
            dwp = 2.0 - 12.0 * e + 12.0 * e ** 2
            diag = fba * forms.d2h(e) + p.w * (dwp + 2.0 * p.alpha * osq)
            rhs = diag * de
            if not split:
                oed = sum(etas[j] * detas[j] for j in range(num_eta) if j != i)
                rhs = (2.0 * rho2 * (p.c_alpha - p.c_beta) * forms.dh(e) * dc
                       + rhs + 4.0 * p.w * p.alpha * e * oed)
            src.append(de / ctx.dt + p.L * rhs)
            flux.append(tuple(p.L * p.kappa_eta * d for d in tctx.du[2 + i]))
        return src, flux

    return tangent


def make_tfe_density(p: Bench2Params, num_eta: int = NUM_ETA):
    f_chem = make_f_chem(p, num_eta)

    def tfe_density(ctx):
        c = ctx.u[0]
        etas = ctx.u[2:]
        dc = ctx.du[0]
        e = f_chem(c, etas) + p.kappa_c / 2.0 * (dc[0] ** 2 + dc[1] ** 2)
        for i in range(num_eta):
            de = ctx.du[2 + i]
            e = e + p.kappa_eta / 2.0 * (de[0] ** 2 + de[1] ** 2)
        return e

    return tfe_density


def kernel_constants(p: Bench2Params) -> dict:
    return dict(rho2=p.rho ** 2, c_alpha=p.c_alpha, c_beta=p.c_beta,
                kappa_c=p.kappa_c, kappa_eta=p.kappa_eta, M=p.M, w=p.w,
                alpha=p.alpha, L=p.L)


def make(nx: int = 100, ny: int = 100, Lx: float = 200.0, Ly: float = 200.0,
         params: Bench2Params = Bench2Params(), num_eta: int = NUM_ETA,
         **overrides) -> BenchmarkProblem:
    p = params
    terms = make_terms(p, num_eta)
    terms_precond = make_terms(p, num_eta, split=True)
    tangents = {False: make_terms_tangent(p, num_eta),
                True: make_terms_tangent(p, num_eta, split=True)}

    def kernel_jvp(grid, device, dirichlet=(), split=False, form="gather"):
        from pfhubbenchmarks_tpu_torch.ops.chac_jvp import make_chac_jvp

        return make_chac_jvp(grid, tangents[split], kernel_constants(p),
                             num_eta=num_eta, split=split, device=device,
                             dirichlet=dirichlet, form=form)

    def kernel_residual(grid, device, dirichlet=(), form="gather"):
        from pfhubbenchmarks_tpu_torch.ops.chac_jvp import make_chac_residual

        return make_chac_residual(grid, terms, kernel_constants(p),
                                  num_eta=num_eta, device=device,
                                  dirichlet=dirichlet, form=form)

    return BenchmarkProblem(
        name="bench2" if num_eta == NUM_ETA else f"bench2_eta{num_eta}",
        grid=CrossedTriGrid(nx, ny, Lx, Ly),
        field_names=("c", "mu") + tuple(f"eta{i+1}" for i in range(num_eta)),
        terms=terms,
        # the CH (c, mu) block and one scalar block per eta, enabled by
        # SolverConfig.field_split
        terms_precond=terms_precond,
        field_groups=((0, 1),) + tuple((2 + i,) for i in range(num_eta)),
        ic_fns=[ic_c(p), lambda x, y: 0.0] + [ic_eta(p, i) for i in range(num_eta)],
        observables={
            "total_free_energy": make_tfe_density(p, num_eta),
            "total_solute": lambda ctx: ctx.u[0],
        },
        csv_columns=("time", "total_free_energy", "total_solute"),
        kernel_jvp=kernel_jvp,
        kernel_residual=kernel_residual,
        outer_jvp_form="box",
        residual_form="box",
        **{"time": TimeConfig(dt0=1e-2, dt_min=1e-4, end_time=100.0,
                              grow_threshold=5),
           "solver": SolverConfig(line_search="cp", precond_rule="dunavant1",
                                  krylov_atol_frac=0.1, gmg_coarse_sweeps=8,
                                  newton_stall_abort=5, gmg_nu_fine_pre=1,
                                  gmres_restart=16, field_split=True),
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench2")
