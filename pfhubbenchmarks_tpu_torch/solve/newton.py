"""Newton(-Krylov) with PETSc SNES 'newtonls' semantics.

Counterpart of ``pfhubbenchmarks_tpu/solve/newton.py:make_newton_solver``.
The nonlinear solve is a Python loop; each Newton iteration reads its
residual norm to the host (one sync), and the inner FGMRES one value set
per Krylov iteration. Convergence mirrors SNES defaults:

  converged: ||F|| < atol  or  ||F|| < rtol ||F0||  or  the step-size test
             (only on a converged linear solve)
  diverged:  ||F|| > divtol ||F0||, NaN, a linear solve that made no
             progress, the stall abort, or max_it

The linear solve of a Newton iteration takes one of two branches, as in
the JAX package (``newton.py:257-280``):

- Mixed precision (``SolverConfig.mixed_precision``, every time-dependent
  benchmark): the residual and the state are f64; the Krylov solve (J.v,
  basis, preconditioner) runs in f32. The J.v comes from
  ``lowp_jvp_factory``, the benchmark's hand-written kernel on CUDA (its
  plain version on CPU tensors); without one the solver raises.
- f64 (``mixed_precision=False``: poisson, poisson3d, elast): the J.v is
  ``torch.func.jvp`` of the f64 residual at the iterate, FGMRES runs in
  f64, and the preconditioner's output is cast to the state's dtype (the
  JAX package's ``Mc``). No kernel is on this branch: the JAX package runs
  it in XLA.

Line searches: 'basic' (the full step) and 'cp' (one secant step on
``<F(x + l d), d>``, ``newton.py:60-79``). With ``fast_linesearch`` the cp
residual is the f32 one while ``||F||`` stays far above the f32 noise floor
measured at the initial guess (``newton.py:197-214``). ``fast_residual``
(``newton.py:157-189, 284-286``) does the same for the Newton residual
itself: the residual of each new iterate is the f32 one while both its f32
norm and the gate stay at or above ``max(margin * floor, 100 atol,
10 report_atol)``, else the f64 one (a host-side branch here, ``lax.cond``
in the JAX package). ``precond_lag``:
'newton' builds the preconditioner at every Newton iterate, 'solve' once
per solve at the initial guess (``newton.py:217-227``); a lagged
preconditioner never hands FGMRES its (z, A z) pair, whose A z would be
linearized at the lagged state.
"""

from __future__ import annotations

import math
import typing
import warnings

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.config import SolverConfig, check_supported
from pfhubbenchmarks_tpu_torch.solve import tree as tr
from pfhubbenchmarks_tpu_torch.solve.krylov import SOLVERS


class NewtonResult(typing.NamedTuple):
    x: typing.Any
    iters: int                  # SNES-equivalent count under report_atol
    converged: bool
    res_norm: float             # final ||F||
    krylov_iters: int           # cumulative inner iterations
    norm_hist: list             # ||F_k|| per Newton iteration (inf-padded)


def _cp_step(res_ls, x, d, F, normF) -> float:
    """PETSc SNESLineSearchCP with max_its=1: one secant update for the root
    of g(l) = <F(x + l d), d> from (0, g0) and (1, g1). A degenerate secant
    (|l| < 1e-3 or non-finite) falls back to the full step, as the JAX
    package does (the nonsymmetric CH system can make <F, d> vanish along a
    good Newton direction)."""
    g0 = float(tr.vdot(F, d))
    g1 = float(tr.vdot(res_ls(tr.add(x, d), normF), d))
    denom = g1 - g0
    lam = -g0 / denom if denom != 0 else 1.0
    if not math.isfinite(lam) or abs(lam) < 1e-3:
        return 1.0
    return lam


def newton_direction(krylov, lowp_jvp_factory, Minv, x, F, w_prev_lp, dt_lp,
                     krylov_kwargs):
    """One linear solve of a Newton iteration: ``J d = -F`` in f32, with J
    the f32 J.v at ``x`` (``lowp_jvp_factory``) and the preconditioner
    ``Minv``. Returns ``d`` in the state's dtype and the Krylov result."""
    jvp_fn = lowp_jvp_factory(tr.cast(x, torch.float32), w_prev_lp, dt_lp)
    sol = krylov(jvp_fn, tr.cast(tr.neg(F), torch.float32), Minv=Minv,
                 **krylov_kwargs)
    return tr.cast(sol.x, x[0].dtype), sol


def f64_direction(krylov, res_fn, Minv, x, F, krylov_kwargs):
    """The f64 branch's linear solve: ``J d = -F`` in the state's dtype, with
    J.v = ``torch.func.jvp`` of ``res_fn`` (the f64 residual) at ``x``, and
    ``Minv``'s output cast to that dtype; the wrapper also keeps a (z, A z)
    pair from FGMRES, as the JAX package's ``Mc`` does. Returns ``d`` and the
    Krylov result."""
    dtype = F[0].dtype

    def jvp_fn(v):
        return torch.func.jvp(res_fn, (x,), (v,))[1]

    sol = krylov(jvp_fn, tr.neg(F), Minv=lambda r: tr.cast(Minv(r), dtype),
                 **krylov_kwargs)
    return sol.x, sol


def make_newton_solver(residual, cfg: SolverConfig, precond_build, *,
                       lowp_jvp_factory, residual_lowp=None):
    """Build ``solve(w_guess, w_prev, dt) -> NewtonResult``.

    ``residual(w, w_prev, dt)`` is the f64 assembled residual;
    ``precond_build(w, w_prev, dt) -> Minv``; ``lowp_jvp_factory(x, w_prev,
    dt) -> jvp(v)`` gives the f32 Krylov operator at the f32 state (None on
    the f64 branch, ``cfg.mixed_precision`` False, which never reads it);
    ``residual_lowp`` is the f32 residual the fast cp line search reads.
    """
    check_supported(cfg)
    if cfg.mixed_precision and lowp_jvp_factory is None:
        raise ValueError("mixed precision needs the f32 Krylov operator "
                         "(lowp_jvp_factory); the f64 branch is "
                         "mixed_precision=False")
    krylov = SOLVERS[cfg.krylov]
    if cfg.krylov_forcing == "ew" and cfg.ew_dt_min is None:
        warnings.warn(
            "krylov_forcing='ew' with no ew_dt_min gate: ungated EW was "
            "measured to break adaptive-controller parity. Set ew_dt_min to "
            "a calibrated gate (bench1 uses 5.0) or to 0.0 to run ungated.",
            stacklevel=2)
    krylov_atol = max(cfg.krylov_atol, cfg.krylov_atol_frac * cfg.newton_atol)
    krylov_kwargs = dict(rtol=cfg.krylov_rtol, atol=krylov_atol,
                         maxiter=cfg.krylov_max_iters, restart=cfg.gmres_restart)
    lowp = torch.float32
    fast_ls = (residual_lowp is not None and cfg.fast_linesearch
               and cfg.line_search != "basic")
    fast_res = residual_lowp is not None and cfg.fast_residual

    def solve(w_guess, w_prev, dt):
        dt = float(dt)
        dt_lp = float(np.float32(dt))
        w_prev_lp = tr.cast(w_prev, lowp)
        x = w_guess
        F = residual(x, w_prev, dt)
        n0 = float(tr.norm(F))

        def staged(xl, gate):
            """The f32 residual at ``xl`` while both ``gate`` and its own
            norm stay at or above the switch, else the f64 one."""
            F32 = residual_lowp(tr.cast(xl, lowp), w_prev_lp, dt_lp)
            if not (gate < switch or float(tr.norm(F32)) < switch):
                return tr.cast(F32, w_guess[0].dtype)
            return residual(xl, w_prev, dt)

        def res_ls(xl, gate):
            """The line search's residual (the gate is the current ||F||):
            staged under either switch, as the JAX package's ``ls_res`` and
            ``res_staged``."""
            return (staged(xl, gate) if fast_ls or fast_res
                    else residual(xl, w_prev, dt))

        if fast_ls or fast_res:
            # the f32 assembly's noise floor at the initial guess
            F0_32 = residual_lowp(tr.cast(x, lowp), w_prev_lp, dt_lp)
            floor = float(tr.norm(tr.sub(tr.cast(F0_32, w_guess[0].dtype), F)))
            switch = max(cfg.fast_residual_margin * floor,
                         cfg.newton_atol * 100.0,
                         (cfg.report_atol or 0.0) * 10.0)
        normF = n0
        hist = [math.inf] * (cfg.newton_max_iters + 1)
        hist[0] = n0
        k = 0
        kiters = 0
        converged = n0 < cfg.newton_atol
        failed = not math.isfinite(n0)
        eta = cfg.ew_eta0
        best, since = n0, 0
        Minv_lagged = None
        if cfg.precond_lag == "solve" and not converged and not failed:
            M = precond_build(w_guess, w_prev, dt)
            Minv_lagged = (lambda r: M(r)) if hasattr(M, "minv_matvec") else M
        while not converged and not failed and k < cfg.newton_max_iters:
            kw = krylov_kwargs
            if cfg.krylov_forcing == "ew":
                # dt-gated forcing: fixed KSP rtol below ew_dt_min
                gated = cfg.ew_dt_min and not dt >= cfg.ew_dt_min
                kw = dict(krylov_kwargs,
                          rtol=cfg.krylov_rtol if gated else eta)
            Minv = (Minv_lagged if Minv_lagged is not None
                    else precond_build(x, w_prev, dt))
            if cfg.mixed_precision:
                d, sol = newton_direction(krylov, lowp_jvp_factory, Minv, x,
                                          F, w_prev_lp, dt_lp, kw)
            else:
                d, sol = f64_direction(
                    krylov, lambda u: residual(u, w_prev, dt), Minv, x, F, kw)
            lam = (_cp_step(res_ls, x, d, F, normF)
                   if cfg.line_search == "cp" else 1.0)
            xn = tr.axpy(lam, d, x)
            # an infinite gate leaves the choice to the f32 norm alone
            Fn = (staged(xn, math.inf) if fast_res
                  else residual(xn, w_prev, dt))
            nn = float(tr.norm(Fn))
            k += 1
            snorm = abs(lam) * float(tr.norm(d))
            xnorm = float(tr.norm(xn))
            converged = (nn < cfg.newton_atol or nn < cfg.newton_rtol * n0
                         or (snorm <= cfg.newton_stol * xnorm and sol.converged))
            # a linear solve that made no progress marks the attempt failed
            # (SNES DIVERGED_LINEAR_SOLVE on a truly stuck KSP)
            lin_useless = not sol.converged and sol.res_norm > 0.1 * normF
            failed = (not math.isfinite(nn) or nn > cfg.newton_div_tol * n0
                      or lin_useless)
            if cfg.newton_stall_abort:
                # doomed-attempt abort, gated so it never fires once the best
                # ||F|| is under the SNES-equivalent acceptance threshold
                since = 0 if nn < 0.9 * best else since + 1
                best = min(nn, best)
                floor = max(cfg.report_atol or 0.0, 10.0 * cfg.newton_atol)
                failed = failed or (since >= cfg.newton_stall_abort
                                    and best > floor and not converged)
            if cfg.krylov_forcing == "ew":
                # EW choice 2 with the standard safeguard, clipped to
                # [krylov_rtol, ew_eta_max]
                ratio = nn / max(normF, 1e-300)
                eta_raw = cfg.ew_gamma * ratio * ratio
                safe = cfg.ew_gamma * eta * eta
                eta_n = max(eta_raw, safe if safe > 0.1 else 0.0)
                eta = min(max(eta_n, cfg.krylov_rtol), cfg.ew_eta_max)
            hist[k] = nn
            x, F, normF = xn, Fn, nn
            kiters += sol.iters
        converged = converged and not failed
        iters = k
        if cfg.report_atol is not None:
            # SNES-equivalent count (calibrated against the reference CSVs):
            # the first iteration whose ||F|| fell under report_atol
            hit = [h < cfg.report_atol for h in hist]
            if any(hit):
                iters = hit.index(True)
                converged = converged or not failed
        return NewtonResult(x, iters, converged, normF, kiters, hist)

    return solve
