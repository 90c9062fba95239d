"""Damped Newton, the last rescue of a replayed step.

Counterpart of ``pfhubbenchmarks_tpu/solve/robust.py:make_host_damped_newton``.
Near a dt-fold (bench3's t = 36.47 -> 41.59 step, where the implicit-Euler
branch turns just below the target dt) full Newton steps limit-cycle, and a
damped step is needed. Each iteration takes the f64 residual, a multigrid
build and one f32 FGMRES solve on the benchmark's kernel J.v (the linear
solve of a Newton iteration, ``solve/newton.newton_direction``), then halves
the step length from 1 down to ``lam_min`` until the Armijo test on ||F||
holds: ``||F(x + lam d)|| <= (1 - 1e-4 lam) ||F(x)||`` (PETSc's bt
semantics). The JAX package cuts this loop into small device dispatches for
its TPU worker; here it is a host loop, like the Newton solver's.

The Krylov solve uses the fixed ``krylov_rtol`` and ``krylov_atol``, as the
JAX package's does, whatever the configured forcing.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.solve import tree as tr
from pfhubbenchmarks_tpu_torch.solve.krylov import SOLVERS
from pfhubbenchmarks_tpu_torch.solve.newton import newton_direction


class DampedResult(typing.NamedTuple):
    x: typing.Any
    converged: bool
    res_norm: float             # the last ||F|| evaluated at x
    iters: int                  # accepted damped steps
    krylov_iters: int           # over every linear solve


def make_host_damped_newton(problem, device: torch.device | str, *,
                            max_iters: int = 40, lam_min: float = 1e-4):
    """Returns ``solve(w_guess, w_prev, dt) -> DampedResult``."""
    cfg = problem.solver
    if problem.residual_lowp(device) is None:
        raise NotImplementedError("damped Newton with an f64 Krylov solve is "
                                  "not yet ported (mixed precision only)")
    residual = problem.residual(device)
    pre_build = problem.precond_builder(device)
    jvp_factory = problem.lowp_jvp_factory(device)
    krylov = SOLVERS[cfg.krylov]
    kw = dict(rtol=cfg.krylov_rtol, atol=cfg.krylov_atol,
              maxiter=cfg.krylov_max_iters, restart=cfg.gmres_restart)

    def solve(w_guess, w_prev, dt):
        dt = float(dt)
        dt_lp = float(np.float32(dt))
        w_prev_lp = tr.cast(w_prev, torch.float32)
        x = w_guess
        kiters = 0
        for k in range(max_iters):
            F = residual(x, w_prev, dt)
            nF = float(tr.norm(F))
            if not math.isfinite(nF):
                return DampedResult(x, False, nF, k, kiters)
            if nF < cfg.newton_atol:
                return DampedResult(x, True, nF, k, kiters)
            d, sol = newton_direction(krylov, jvp_factory,
                                      pre_build(x, w_prev, dt), x, F,
                                      w_prev_lp, dt_lp, kw)
            kiters += sol.iters
            lam = 1.0
            while lam >= lam_min:
                xn = tr.axpy(lam, d, x)
                nn = float(tr.norm(residual(xn, w_prev, dt)))
                if math.isfinite(nn) and nn <= (1.0 - 1e-4 * lam) * nF:
                    break
                lam *= 0.5
            else:
                return DampedResult(x, False, nF, k, kiters)
            x = xn
        nF = float(tr.norm(residual(x, w_prev, dt)))
        return DampedResult(x, nF < cfg.newton_atol, nF, max_iters, kiters)

    return solve
