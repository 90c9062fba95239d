"""Weak-form term functions (counterpart of ``pfhubbenchmarks_tpu/models/
forms.py``, after dolfin/pfbase.py:361-460).

Each function returns ``(source, flux)`` contributions for one PDE block,
where the assembled residual is

    r_k = integral( source * test_k + flux . grad(test_k) ) dx

(fem/assembly.py). Pure functions of tensors (or Python scalars): the same
code serves the assembly and ``torch.func.jvp``.
"""

from __future__ import annotations


def cahn_hilliard(c, mu, dmu, dc, c0, dt, M, kappa, dfdc):
    """Mixed Cahn-Hilliard block (dolfin/pfbase.py:361-383).

        d/dt c = div(M grad mu);   mu = f'(c) - kappa lapl(c)

    Returns ((source_c, flux_c), (source_mu, flux_mu)).
    """
    src_c = (c - c0) / dt
    flux_c = tuple(M * d for d in dmu)
    src_mu = mu - dfdc
    flux_mu = tuple(-kappa * d for d in dc)
    return (src_c, flux_c), (src_mu, flux_mu)


def allen_cahn(eta, deta, eta0, dt, L, kappa, dfdeta, f=0.0):
    """Allen-Cahn block (dolfin/pfbase.py:396-408).

        d/dt eta = -L (f'(eta) - kappa lapl(eta)) + f
    """
    src = (eta - eta0) / dt + L * dfdeta - f
    flux = tuple(L * kappa * d for d in deta)
    return src, flux


def allen_cahn_rhs_ibp(deta, L, kappa, dfdeta, f=0.0):
    """The integrated-by-parts AC right-hand side (dolfin/pfbase.py:385-394),
    as (source, flux) contributions *of the RHS* (callers subtract)."""
    src = -L * dfdeta + f
    flux = tuple(-L * kappa * d for d in deta)
    return src, flux


def poisson(du, f, M=1.0):
    """Poisson block (dolfin/pfbase.py:410-421): div(M grad u) = f."""
    src = -f
    flux = tuple(-M * d for d in du)
    return src, flux


def diffusion(u, du, u0, dt, L, D, f1=(0.0, 0.0), f2=0.0):
    """Transient diffusion block (dolfin/pfbase.py:434-447).

        d/dt u = L div(D grad u + f1) + f2
    """
    src = (u - u0) / dt - f2
    flux = tuple(L * (D * d + f) for d, f in zip(du, f1))
    return src, flux


def euler_bwd(u, u0, dt, f):
    """Plain backward-Euler block d/dt u = f (dolfin/pfbase.py:449-460)."""
    return (u - u0) / dt - f, (0.0, 0.0)  # caller broadcasts flux dims


def h(u):
    """Quintic interpolant (dolfin/pfbase.py:467-468)."""
    return u**3 * (6.0 * u**2 - 15.0 * u + 10.0)


def dh(u):
    """Its derivative (dolfin/pfbase.py:471-472)."""
    return 3.0 * u**2 * (6.0 * u**2 - 15.0 * u + 10.0) + u**3 * (12.0 * u - 15.0)


def d2h(u):
    """The derivative of ``dh`` as written (for the hand-written tangents)."""
    return (6.0 * u * (6.0 * u**2 - 15.0 * u + 10.0)
            + 6.0 * u**2 * (12.0 * u - 15.0) + 12.0 * u**3)
