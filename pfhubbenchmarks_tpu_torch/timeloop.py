"""Adaptive implicit-Euler time loop (host loop).

Counterpart of ``pfhubbenchmarks_tpu/timeloop.py`` (``Runner``, ``run``),
after the reference time loop (dolfin/bench1.py:145-198):

  - every solve attempt starts from the previous accepted state,
  - on nonconvergence: ``dt = max(dt/2, dt_min)``, retry; the run fails
    after ``max_retries_at_dt_min`` failures with dt at dt_min,
  - after success: ``dt = 2 dt`` if Newton iters < grow_threshold, else
    ``dt = max(dt/2, dt_min)`` (or keep dt inside a hysteresis band),
    capped at dt_max,
  - loop while ``t < end_time + eps`` (the final step overshoots end_time),
  - after each accepted step the problem's ``abort_condition`` on the CSV
    row may stop the run (bench3: TFE < 0), the row kept.

The loop drives a 2D ``BenchmarkProblem`` (states ``(v, m)``) and a 3D
``Benchmark3DProblem`` (benchmarks/bench1_3d.py, states ``(v,)``) alike: it
only reads the problem's factory methods and configs.

Replay (``time_grid``): the dt of each step is taken from a reference time
grid (the JAX package's ``run(time_grid=...)``, ``timeloop.py:233-425``), so
each row's solve accuracy can be measured apart from the dt controller. EW
forcing gives way to the fixed KSP rtol: it trades linear-solve accuracy that
the replay exists to measure (the JAX package's default ``replay_forcing``,
which no caller changes). A step whose
attempt from the previous state fails goes down the rescue ladder, in this
order: the substep warm start (nsub 2, 4, 8 implicit-Euler substeps, then
the full dt from their end), continuation in dt from the previous state,
damped Newton (solve/robust.py) from the warm guess and then from the
deepest continuation iterate, and last the step as 2 x (dt/2) substeps,
which is the nsub = 2 chain already solved. A step no rung solves ends the
run with its rows (``replay_partial``) or raises. The JAX package's
``replay_damped`` switch is left out: the damped rungs always run.

The whole-run on-device loop (``run_fused``, with its device-side
``abort_device``) is not yet ported.
"""

from __future__ import annotations

import dataclasses
import time as _time
import typing

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.benchmarks.base import BenchmarkProblem
from pfhubbenchmarks_tpu_torch.solve.newton import make_newton_solver

if typing.TYPE_CHECKING:
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import Benchmark3DProblem

_EPS = 3e-16  # DOLFIN_EPS


@dataclasses.dataclass
class StepStats:
    step: int
    t: float
    dt: float               # dt actually used for this accepted step
    newton_iters: int
    krylov_iters: int
    retries: int
    res_norm: float
    wall: float
    dt_next: float = 0.0
    row: list = dataclasses.field(default_factory=list)
    # totals over every attempt of the step, failed ones and rescue rungs
    # (the damped rungs' own iterations) included
    newton_iters_all: int = 0
    krylov_iters_all: int = 0
    # replay: the rung that solved the step ("" for its first attempt) and
    # one record per rung tried (rung, newton, krylov, converged)
    rescue: str = ""
    ladder: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunResult:
    rows: np.ndarray              # [n_steps, 1 + n_observables]
    stats: list[StepStats]
    state: tuple
    wall_total: float
    columns: tuple[str, ...]


class Runner:
    """Holds the solver and observables of a problem on one device."""

    def __init__(self, problem: "BenchmarkProblem | Benchmark3DProblem",
                 device: torch.device | str):
        self.problem = problem
        self.device = torch.device(device)
        self.newton = make_newton_solver(
            problem.residual(self.device), problem.solver,
            problem.precond_builder(self.device),
            lowp_jvp_factory=problem.lowp_jvp_factory(self.device),
            residual_lowp=problem.residual_lowp(self.device))
        self.obs_fns = problem.observable_fns(self.device)
        self.columns = problem.csv_columns[1:]
        self._damped = None

    def step(self, w_guess, w_prev, dt):
        """One solve attempt and its observables (as host floats)."""
        res = self.newton(w_guess, w_prev, dt)
        obs = [float(self.obs_fns[c](res.x)) for c in self.columns]
        return res, obs

    def host_damped(self):
        """Damped Newton (solve/robust.py) for the replay rescue, built at
        first use: only a replay that reaches a damped rung pays for it."""
        if self._damped is None:
            from pfhubbenchmarks_tpu_torch.solve.robust import (
                make_host_damped_newton)

            self._damped = make_host_damped_newton(self.problem, self.device)
        return self._damped

    def run(self, **kwargs) -> "RunResult":
        return run(self.problem, device=self.device, _runner=self, **kwargs)


_CONTINUATION = (0.25, 0.5, 0.7, 0.85, 0.95, 1.0)


def _rescue(attempt, damped, w0, dt, ladder):
    """The replay rescue ladder for a step from ``w0`` over ``dt`` whose
    first attempt failed (JAX ``timeloop.py:320-403``). ``attempt`` and
    ``damped`` are the counted ``Runner.step`` and ``Runner.host_damped()``;
    each rung tried is appended to ``ladder``.
    Returns ``(res, obs, rung)`` of the solve that is accepted, or None."""

    def note(rung, newton, krylov, converged):
        ladder.append(dict(rung=rung, newton=newton, krylov=krylov,
                           converged=bool(converged)))

    # substep warm start: Newton may diverge from the previous state at a
    # replayed dt (bench1's t = 52.7 -> 65.5 coarsening step); the end of an
    # nsub-substep chain lands near the dt-step's root, and Newton from
    # there solves the same discrete system. Every substep of a chain runs,
    # as in the JAX package.
    warm = chain2 = None
    for nsub in (2, 4, 8):
        g, ok, n, k = w0, True, 0, 0
        for _ in range(nsub):
            rs, ro = attempt(g, g, dt / nsub)
            ok, n, k = ok and rs.converged, n + rs.iters, k + rs.krylov_iters
            g = rs.x
        note(f"substep{nsub} chain", n, k, ok)
        if not ok:
            continue
        if nsub == 2:
            chain2 = (rs, ro)
        warm = g
        res, obs = attempt(g, w0, dt)
        note(f"substep{nsub} full dt", res.iters, res.krylov_iters,
             res.converged)
        if res.converged:
            return res, obs, f"substep{nsub}"
    # continuation in dt from w0: each root seeds the next, so the guesses
    # follow the dt-system's own branch (bench2's t = 81.51 step)
    g = w0
    for frac in _CONTINUATION:
        res, obs = attempt(g, w0, frac * dt)
        note(f"continuation {frac:g}", res.iters, res.krylov_iters,
             res.converged)
        if not res.converged:
            break
        g = res.x
    else:
        return res, obs, "continuation"
    # damped Newton from the warm guess, then from the deepest continuation
    # iterate (bench3's t = 41.59 step tries both); a root it finds is
    # packaged by one production solve for its result and observables
    for rung, guess in (("damped from warm", warm),
                        ("damped from continuation", g)):
        if guess is None:
            continue
        out = damped(guess, w0, dt)
        note(rung, out.iters, out.krylov_iters, out.converged)
        if out.converged:
            res, obs = attempt(out.x, w0, dt)
            note(f"{rung}: package", res.iters, res.krylov_iters,
                 res.converged)
            if res.converged:
                return res, obs, rung
    # the dt-system may be unsolvable from this trajectory (bench3's
    # t = 41.59 step sits past a fold of the implicit-Euler branch): accept
    # the step as 2 x (dt/2) implicit Euler, which is the nsub = 2 chain
    # (the JAX package solves it again, to the same state); one row's time
    # operator differs, the later rows are back on the grid
    if chain2 is not None:
        note("2x(dt/2)", 0, 0, True)
        return (*chain2, "2x(dt/2)")
    return None


def run(problem: "BenchmarkProblem | Benchmark3DProblem", *,
        device: torch.device | str,
        end_time: float | None = None, max_steps: int | None = None,
        verbose: bool = True, max_retries_at_dt_min: int = 60,
        time_grid=None, replay_partial: bool = False,
        _runner: "Runner | None" = None) -> RunResult:
    """Run a benchmark from its IC to its final time; returns the CSV rows
    and per-step stats.

    ``time_grid``: absolute times to step to (replay mode, see the module
    docstring) with fixed Krylov forcing; the run follows the grid to its
    last row. A step that no rung of the rescue ladder solves raises, or
    with ``replay_partial`` ends the run with the rows so far. A caller's
    ``_runner`` keeps its own forcing, as in the JAX package."""
    if time_grid is not None and _runner is None:
        problem = dataclasses.replace(problem, solver=dataclasses.replace(
            problem.solver, krylov_forcing="fixed"))
    tc = problem.time
    if end_time is None:
        end_time = (float(time_grid[-1]) if time_grid is not None
                    else tc.end_time)
    runner = _runner or Runner(problem, device)
    w = problem.initial_state(runner.device)
    t, dt = tc.t0, tc.dt0
    counts = [0, 0]   # Newton and Krylov iterations of the step, all attempts

    def attempt(w_guess, w_prev, dt_):
        res, obs = runner.step(w_guess, w_prev, dt_)
        counts[0] += res.iters
        counts[1] += res.krylov_iters
        return res, obs

    def damped(w_guess, w_prev, dt_):
        out = runner.host_damped()(w_guess, w_prev, dt_)
        counts[0] += out.iters
        counts[1] += out.krylov_iters
        return out

    rows = []
    stats: list[StepStats] = []
    wall_start = _time.time()
    step = 0
    while t < end_time + _EPS:
        if max_steps is not None and step >= max_steps:
            break
        if time_grid is not None:
            if step >= len(time_grid):
                break
            dt = float(time_grid[step]) - t
            if dt <= 0:
                raise ValueError(f"time_grid not increasing at index {step}")
        step += 1
        tprev = t
        w0 = w
        retries = 0
        t = tprev + dt
        t_attempt = _time.time()
        counts[:] = 0, 0
        res, obs = attempt(w0, w0, dt)
        rescue, ladder = "", []
        if not res.converged and time_grid is not None:
            rescued = _rescue(attempt, damped, w0, dt, ladder)
            if rescued is None:
                msg = (f"{problem.name}: replay step {step} (t={t:.6g}) did "
                       f"not converge; |F|={res.res_norm:.3e}")
                if not replay_partial:
                    raise RuntimeError(msg)
                print(f"{msg}; stopping with {len(rows)} rows")
                return RunResult(rows=np.asarray(rows), stats=stats, state=w0,
                                 wall_total=_time.time() - wall_start,
                                 columns=problem.csv_columns)
            res, obs, rescue = rescued
            retries = 1
            if verbose:
                print(f"  replay step {step}: {rescue}" + (
                    " (unsolvable at dt, branch fold)"
                    if rescue == "2x(dt/2)" else ""))
        while not res.converged:
            retries += 1
            if dt <= tc.dt_min * (1 + 1e-12) and retries > max_retries_at_dt_min:
                raise RuntimeError(
                    f"{problem.name}: step {step} failed {retries} times at "
                    f"dt_min={tc.dt_min}; |F|={res.res_norm:.3e}")
            dt = max(0.5 * dt, tc.dt_min)
            t = tprev + dt
            if verbose:
                print(f"  REPEATING step {step}. t={t:.6g} dt={dt:.6g}")
            res, obs = attempt(w0, w0, dt)
        niters = res.iters
        w = res.x
        wall = _time.time() - t_attempt
        dt_used = dt

        # reference adaptive rule (dolfin/bench1.py:179-183), optional
        # hysteresis band and dt_max ceiling
        if niters < tc.grow_threshold:
            dt = 2.0 * dt
        elif tc.shrink_threshold is None or niters > tc.shrink_threshold:
            dt = max(0.5 * dt, tc.dt_min)
        if tc.dt_max is not None:
            dt = min(dt, tc.dt_max)

        rows.append([t] + obs)
        st = StepStats(step=step, t=t, dt=dt_used, newton_iters=niters,
                       krylov_iters=res.krylov_iters, retries=retries,
                       res_norm=res.res_norm, wall=wall, dt_next=dt,
                       row=rows[-1], newton_iters_all=counts[0],
                       krylov_iters_all=counts[1], rescue=rescue,
                       ladder=ladder)
        stats.append(st)
        if verbose:
            obs_str = ", ".join(f"{c}={v:.10g}"
                                for c, v in zip(problem.csv_columns[1:], obs))
            print(f"step {step:4d}  t={t:<12.6g} dt={st.dt:<10.4g} "
                  f"newton={niters} krylov={st.krylov_iters} {obs_str}  "
                  f"({wall:.3f}s)")
        if problem.abort_condition is not None:
            if problem.abort_condition(dict(zip(problem.csv_columns, rows[-1]))):
                if verbose:
                    print(f"abort condition hit at step {step}; stopping")
                break

    return RunResult(rows=np.asarray(rows), stats=stats, state=w,
                     wall_total=_time.time() - wall_start,
                     columns=problem.csv_columns)
