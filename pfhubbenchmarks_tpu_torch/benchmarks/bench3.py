"""PFHub Benchmark 3: dendritic solidification, Allen-Cahn + heat equation.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench3.py``. Reference:
dolfin/bench3.py — 960x960 domain, 350x350 crossed mesh (:21-23), params
W0=1, m=4, eps_m=0.05, tau0=1, D=10, undercooling Delta=-0.3 (:32-38),
lambda = D tau0 / (0.6267 W0^2) (:67), circular seed IC (pfbase.py:293-320)
with r=8, w=1, vin=1, vout=-1 (:52-58), latent-heat coupling: the U
equation gets 0.5 * dphi/dt with the time derivative substituted by the
implicit AC right-hand side (:88-93). Aborts when the total free energy
goes negative (:254-258). The time and solver configurations are the JAX
package's, whose comments record the measurements behind each setting.

The hierarchy is 350/175/35/7 (ratios 2, 5, 5): kernel D moves data
between 350^2 and 175^2 and kernel H between the odd-ratio pairs; the 7^2
coarsest level has 2 (8^2 + 7^2) = 226 dofs, under the 1500-dof cap, so it
is solved by the exact dense inverse, in the JAX package as here.

``anisotropy=True`` is the PFHub BM3 as published: the four-fold
a(theta) = 1 + eps_m cos(m (theta - theta0)), theta = atan2(phi_y, phi_x),
with the Kobayashi rotation flux, as the JAX package writes it (its atan2
and double ``where`` keep the bulk, where grad phi = 0, free of NaN in
every forward-mode derivative). The reference authored it and switched it
off (dolfin/bench3.py:72-81). Its hand-written tangent reads the state's
gradient (``make_aniso_terms``); kernels W, the gather and the two chains
run it at the physics "acha" (csrc/phys_acha.cuh). Kernel N builds the
blocks at zero state gradient, where a = 1 and a' = 0 with zero tangent, so
the isotropic kernel N builds them (ops/node_blocks.py). The CLI has no
anisotropy flag (nor has the JAX package's); the entry point is
``timeloop.run(make(anisotropy=True), device="cuda")``.

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench3 --device cuda``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.models import forms


@dataclasses.dataclass(frozen=True)
class Bench3Params:
    W0: float = 1.0
    m: int = 4
    epsilon_m: float = 0.05
    theta0: float = 0.0
    tau0: float = 1.0
    D: float = 10.0
    Delta: float = -0.3
    r_ic: float = 8.0
    w_ic: float = 1.0
    v_in: float = 1.0
    v_out: float = -1.0

    @property
    def lam(self) -> float:
        return self.D * self.tau0 / (0.6267 * self.W0 ** 2)


def ic_phi(p: Bench3Params):
    """Circular seed at the domain corner (pfbase.py:301-317)."""

    def fn(x, y):
        r = np.sqrt(x ** 2 + y ** 2)
        mid = p.v_out + 0.5 * (p.v_in - p.v_out) * (
            1.0 + np.cos(np.pi * (r - p.r_ic + 0.5 * p.w_ic) / p.w_ic))
        return np.where(
            r < p.r_ic - 0.5 * p.w_ic, p.v_in,
            np.where(r > p.r_ic + 0.5 * p.w_ic, p.v_out, mid))

    return fn


def make_terms(p: Bench3Params):
    """(terms, terms_tangent, f_chem) of BM3's isotropic weak form (a = 1)."""
    lam = p.lam
    W2 = p.W0 ** 2
    inv_tau = 1.0 / p.tau0

    def f_chem(U, phi):
        return (-0.5 * phi ** 2 + 0.25 * phi ** 4
                + lam * U * phi * (1.0 - 2.0 / 3.0 * phi ** 2 + 0.2 * phi ** 4))

    def dfdp(U, phi):
        # (phi - lam U (1 - phi^2)) (1 - phi^2) = -d f_chem / d phi
        return (phi - lam * U * (1.0 - phi ** 2)) * (1.0 - phi ** 2)

    def terms(ctx):
        U, phi = ctx.u
        U0, phi0 = ctx.u0
        dU, dphi = ctx.du
        g = dfdp(U, phi)
        # U equation: diffusion + 0.5 * dphi/dt substituted by the AC RHS
        # (dolfin/bench3.py:88-93)
        src_U = (U - U0) / ctx.dt - 0.5 * inv_tau * g
        flux_U = (p.D * dU[0] + 0.5 * inv_tau * (W2 * dphi[0]),
                  p.D * dU[1] + 0.5 * inv_tau * (W2 * dphi[1]))
        # phi equation: AC with L = 1/tau, kappa = W^2, dfdeta = -dfdp
        src_p, flux_p = forms.allen_cahn(phi, dphi, phi0, ctx.dt, inv_tau, W2, -g)
        return [src_U, src_p], [flux_U, flux_p]

    def terms_tangent(ctx, tctx):
        """Pointwise tangent of ``terms`` at ``ctx`` in the direction of
        ``tctx``, written by hand; kernel G's ``ACH::tangent``
        (csrc/ach_jvp.cu) mirrors it. With s = 1 - phi^2, g = (phi -
        lam U s) s, dg = -lam s^2 dU + (1 - 3 phi^2 + 4 lam U phi s) dphi:

            d src_U   = dU / dt - (1/2)(1/tau0) dg
            d flux_U  = D grad(dU) + (1/2)(W0^2/tau0) grad(dphi)
            d src_phi = dphi / dt - (1/tau0) dg
            d flux_phi = (W0^2/tau0) grad(dphi)
        """
        U, phi = ctx.u
        dU, dphi = tctx.u
        gdU, gdphi = tctx.du
        p2 = phi * phi
        s = 1.0 - p2
        gU = -lam * s * s
        gp = 1.0 - 3.0 * p2 + 4.0 * lam * U * phi * s
        dg = gU * dU + gp * dphi
        kw = inv_tau * W2
        src_U = dU / ctx.dt - 0.5 * inv_tau * dg
        flux_U = tuple(p.D * a + 0.5 * kw * b for a, b in zip(gdU, gdphi))
        src_p = dphi / ctx.dt - inv_tau * dg
        flux_p = tuple(kw * b for b in gdphi)
        return [src_U, src_p], [flux_U, flux_p]

    return terms, terms_tangent, f_chem


def aniso(p: Bench3Params, dphi):
    """a(theta) = 1 + eps_m cos(m (theta - theta0)) and a'(theta) at the
    gradient ``dphi`` of phi, with the JAX package's double ``where``: the
    direction (1, 0) stands in for a gradient with |grad phi|^2 <= 1e-20
    before atan2, and a = 1, a' = 0 are selected there."""
    g2 = dphi[0] ** 2 + dphi[1] ** 2
    safe = g2 > 1e-20
    dx = torch.where(safe, dphi[0], 1.0)
    dy = torch.where(safe, dphi[1], 0.0)
    theta = torch.atan2(dy, dx)
    a = 1.0 + p.epsilon_m * torch.cos(p.m * (theta - p.theta0))
    aprime = -p.epsilon_m * p.m * torch.sin(p.m * (theta - p.theta0))
    return torch.where(safe, a, 1.0), torch.where(safe, aprime, 0.0)


def make_aniso_terms(p: Bench3Params):
    """(terms, terms_tangent) of BM3's anisotropic weak form: the JAX
    package's ``terms`` under ``anisotropy=True``, expression for
    expression, and its tangent written by hand."""
    lam = p.lam
    W0_sq = p.W0 ** 2
    inv_tau0 = 1.0 / p.tau0
    kappa = W0_sq * inv_tau0

    def dfdp(U, phi):
        return (phi - lam * U * (1.0 - phi ** 2)) * (1.0 - phi ** 2)

    def terms(ctx):
        U, phi = ctx.u
        U0, phi0 = ctx.u0
        dU, dphi = ctx.du
        a, aprime = aniso(p, dphi)
        # the Kobayashi rotation flux W W' (-phi_y, phi_x) (the JAX
        # package's comment derives it)
        wwp = W0_sq * a * aprime
        W2 = (p.W0 * a) ** 2
        inv_tau = 1.0 / (p.tau0 * a ** 2)
        g = dfdp(U, phi)
        rot = (-wwp * dphi[1], wwp * dphi[0])
        src_U = (U - U0) / ctx.dt - 0.5 * inv_tau * g
        flux_U = (p.D * dU[0] + 0.5 * inv_tau * (W2 * dphi[0] + rot[0]),
                  p.D * dU[1] + 0.5 * inv_tau * (W2 * dphi[1] + rot[1]))
        src_p, flux_p = forms.allen_cahn(phi, dphi, phi0, ctx.dt, inv_tau, W2,
                                         -g)
        flux_p = (flux_p[0] + inv_tau * rot[0], flux_p[1] + inv_tau * rot[1])
        return [src_U, src_p], [flux_U, flux_p]

    def terms_tangent(ctx, tctx):
        """Pointwise tangent of ``terms`` at ``ctx`` in the direction of
        ``tctx``, written by hand; kernel W's, the gather's and the chains'
        ``ACHA::tangent`` (csrc/phys_acha.cuh) mirrors it. With kappa =
        W0^2/tau0, R(x, y) = (-y, x), beta = a'/a, inv_tau = 1/(tau0 a^2),
        r^2 = |grad phi|^2 and d theta = (phi_x dphi_y - phi_y dphi_x)/r^2:

            d inv_tau  = -2 inv_tau beta d theta
            d beta     = (a''/a - beta^2) d theta,  a'' = -eps_m m^2 cos(.)
            d src_U    = dU/dt - (1/2)(inv_tau dg + g d inv_tau)
            d src_phi  = dphi/dt - (inv_tau dg + g d inv_tau)
            d flux_phi = kappa (grad dphi + beta R grad dphi
                                + d beta R grad phi)
            d flux_U   = D grad dU + (1/2) d flux_phi

        and off ``safe`` (a = 1, a' = 0 with zero tangent) the isotropic
        tangent, which these give at beta = d beta = d inv_tau = 0."""
        U, phi = ctx.u
        phx, phy = ctx.du[1]
        dU, dphi = tctx.u
        gdU, gdphi = tctx.du
        g2 = phx ** 2 + phy ** 2
        safe = g2 > 1e-20
        dx = torch.where(safe, phx, 1.0)
        dy = torch.where(safe, phy, 0.0)
        psi = p.m * (torch.atan2(dy, dx) - p.theta0)
        cos_psi = torch.cos(psi)
        a = torch.where(safe, 1.0 + p.epsilon_m * cos_psi, 1.0)
        beta = torch.where(safe, -p.epsilon_m * p.m * torch.sin(psi), 0.0) / a
        app_a = torch.where(safe, -p.epsilon_m * p.m ** 2 * cos_psi, 0.0) / a
        dtheta = (dx * gdphi[1] - dy * gdphi[0]) / (dx * dx + dy * dy)
        dbeta = (app_a - beta * beta) * dtheta
        inv_tau = inv_tau0 / (a * a)
        p2 = phi * phi
        s = 1.0 - p2
        g = (phi - lam * U * s) * s
        dg = -lam * s * s * dU + (1.0 - 3.0 * p2 + 4.0 * lam * U * phi * s) * dphi
        d_inv_tau = -2.0 * inv_tau * beta * dtheta
        dgi = inv_tau * dg + g * d_inv_tau
        src_U = dU / ctx.dt - 0.5 * dgi
        src_p = dphi / ctx.dt - dgi
        flux_p = (kappa * (gdphi[0] - beta * gdphi[1] - dbeta * phy),
                  kappa * (gdphi[1] + beta * gdphi[0] + dbeta * phx))
        flux_U = tuple(p.D * a_ + 0.5 * b_ for a_, b_ in zip(gdU, flux_p))
        return [src_U, src_p], [flux_U, flux_p]

    return terms, terms_tangent


def kernel_constants(p: Bench3Params, anisotropy: bool = False) -> dict:
    k = dict(D=p.D, W0_sq=p.W0 ** 2, inv_tau0=1.0 / p.tau0, lam=p.lam)
    if anisotropy:
        k.update(eps_m=p.epsilon_m, m=float(p.m),
                 cos_m_theta0=math.cos(p.m * p.theta0),
                 sin_m_theta0=math.sin(p.m * p.theta0))
    return k


def make(nx: int = 350, ny: int = 350, Lx: float = 960.0, Ly: float = 960.0,
         params: Bench3Params = Bench3Params(), anisotropy: bool = False,
         **overrides) -> BenchmarkProblem:
    p = params
    terms, terms_tangent, f_chem = make_terms(p)
    if anisotropy:
        terms, terms_tangent = make_aniso_terms(p)
    kind = "acha" if anisotropy else "ach"

    def tfe_density(ctx):
        U, phi = ctx.u
        dphi = ctx.du[1]
        if anisotropy:
            a, _ = aniso(p, dphi)
            return f_chem(U, phi) + 0.5 * (p.W0 * a) ** 2 * (dphi[0] ** 2
                                                             + dphi[1] ** 2)
        return f_chem(U, phi) + 0.5 * p.W0 ** 2 * (dphi[0] ** 2 + dphi[1] ** 2)

    def kernel_jvp(grid, device, dirichlet=(), split=False, form="gather"):
        if split:
            raise NotImplementedError("bench3 has no field-split operator")
        from pfhubbenchmarks_tpu_torch.ops.ach_jvp import make_ach_jvp

        return make_ach_jvp(grid, terms_tangent,
                            kernel_constants(p, anisotropy), device=device,
                            dirichlet=dirichlet, form=form, kind=kind)

    def kernel_phys():
        from pfhubbenchmarks_tpu_torch.ops.ach_jvp import constants_of
        from pfhubbenchmarks_tpu_torch.ops.fem_jvp import KernelPhys

        return KernelPhys(kind, terms_tangent,
                          constants_of(kind, kernel_constants(p, anisotropy)))

    return BenchmarkProblem(
        name="bench3",
        grid=CrossedTriGrid(nx, ny, Lx, Ly),
        field_names=("U", "phi"),
        terms=terms,
        ic_fns=[lambda x, y: np.full_like(np.asarray(x, float), p.Delta),
                ic_phi(p)],
        observables={
            "total_free_energy": tfe_density,
            "solid_fraction": lambda ctx: 0.5 * (ctx.u[1] + 1.0),
        },
        observable_scale={"solid_fraction": 1.0 / (Lx * Ly)},
        csv_columns=("time", "total_free_energy", "solid_fraction"),
        kernel_jvp=kernel_jvp,
        kernel_phys=kernel_phys,
        outer_jvp_form="box",
        **{"time": TimeConfig(dt0=1e-2, dt_min=1e-4, end_time=100.0,
                              grow_threshold=5),
           "solver": SolverConfig(line_search="basic", precond_rule="dunavant2",
                                  gmg_nu_pre=3, gmg_nu_post=3,
                                  gmg_nu_fine_pre=1,
                                  fuse_vcycle="split_levels",
                                  krylov_atol_frac=0.1),
           "abort_condition": lambda row: row["total_free_energy"] < 0.0,
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench3")
