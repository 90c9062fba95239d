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

Replay on a reference time grid, its rescue ladder and the whole-run
on-device loop (``run_fused``, with its device-side ``abort_device``) are
not yet ported.
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
    newton_iters_all: int = 0
    krylov_iters_all: int = 0


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

    def step(self, w_guess, w_prev, dt):
        """One solve attempt and its observables (as host floats)."""
        res = self.newton(w_guess, w_prev, dt)
        obs = [float(self.obs_fns[c](res.x)) for c in self.columns]
        return res, obs

    def run(self, **kwargs) -> "RunResult":
        return run(self.problem, device=self.device, _runner=self, **kwargs)


def run(problem: "BenchmarkProblem | Benchmark3DProblem", *,
        device: torch.device | str,
        end_time: float | None = None, max_steps: int | None = None,
        verbose: bool = True, max_retries_at_dt_min: int = 60,
        _runner: "Runner | None" = None) -> RunResult:
    """Run a benchmark from its IC to its final time; returns the CSV rows
    and per-step stats."""
    tc = problem.time
    if end_time is None:
        end_time = tc.end_time
    runner = _runner or Runner(problem, device)
    w = problem.initial_state(runner.device)
    t, dt = tc.t0, tc.dt0

    rows = []
    stats: list[StepStats] = []
    wall_start = _time.time()
    step = 0
    while t < end_time + _EPS:
        if max_steps is not None and step >= max_steps:
            break
        step += 1
        tprev = t
        w0 = w
        retries = 0
        t = tprev + dt
        t_attempt = _time.time()
        res, obs = runner.step(w0, w0, dt)
        newton_all, kry_all = res.iters, res.krylov_iters
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
            res, obs = runner.step(w0, w0, dt)
            newton_all += res.iters
            kry_all += res.krylov_iters
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
                       row=rows[-1], newton_iters_all=newton_all,
                       krylov_iters_all=kry_all)
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
