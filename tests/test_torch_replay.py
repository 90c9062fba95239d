"""Replay on a reference time grid and its rescue ladder, against the JAX
package.

(a) The ladder rung by rung: both packages' ``timeloop.run`` drive a
    scripted runner whose solves succeed or fail by (guess, dt), through
    each rung: the first attempt, the substep warm start at nsub 2, 4 and 8,
    continuation in dt, damped Newton from the warm guess and from the
    deepest continuation iterate, the 2 x (dt/2) fallback and
    ``replay_partial``. The attempted solves, the rows, the Newton counts and
    the retries must match. One difference is by design: the JAX package
    solves the fallback's two dt/2 substeps again after its damped rungs,
    where the port accepts the nsub = 2 chain it has already solved (the
    same solves from the same state); those two attempts are dropped from
    the JAX package's sequence.
(b) bench1 replay at 32^2 on the first 6 rows of the reference grid in both
    packages: time column and Newton counts identical, TFE rel <= 1e-7 and
    solute rel <= 1e-9. Rows 5 and 6 (dt 1.6) are where the two f32 FGMRES
    solves part (91 Krylov iterations in the JAX package, 97 and 88 in the
    port: the rounding of the f32 dots, ``test_torch_krylov_parity.py``),
    which leaves TFE rel 1.2e-9 and solute rel 5.4e-10 there.
(c) The port's damped Newton (``solve/robust.py``) against the JAX
    package's ``make_host_damped_newton`` on bench3 at 70^2 from the IC at
    dt = 1, where the full-step Newton fails: the same converged flag and
    number of damped steps, the state within 1e-10 absolute (f64 states of
    order 1; the f32 Krylov solves part at the 1e-7 level, and each damped
    Newton step squares the error).
(d) The CLI's ``--replay``.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax1
from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax3
from pfhubbenchmarks_tpu.solve.robust import (
    make_host_damped_newton as jax_damped_newton)
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import make as make_torch1
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import make as make_torch3
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)
from pfhubbenchmarks_tpu_torch.solve.robust import (DampedResult,
                                                    make_host_damped_newton)

# ---- (a) the ladder, scripted ---------------------------------------------

GRID = np.array([1.0, 2.0, 4.0, 5.0])


@dataclasses.dataclass(frozen=True)
class State:
    """A scripted solution: the time it solves to and how it was reached
    ("w0"; "diverged" a failed solve's iterate, left at its previous
    state's time; "part" short of the step's end: a chain's inner state or a
    continuation root; "sub<n>" the end of an n-substep chain; "root" from
    damped Newton; "cold" or "from-<guess path>" an accepted full step)."""

    t: float
    path: str = "w0"


def step_frame(prev: State):
    """(t0, D) of the grid step whose interval holds ``prev.t``."""
    k = int(np.searchsorted(GRID, prev.t + 1e-9))
    t0 = GRID[k - 1] if k else 0.0
    return t0, GRID[k] - t0


def newton_ok(mode, guess, prev, dt):
    """Whether a solve converges, by the step's mode and (guess, dt): pp is
    the previous state's progress through the step and f = dt / D; a chain
    substep and the first continuation step start from their own previous
    state."""
    t0, D = step_frame(prev)
    pp, f = (prev.t - t0) / D, dt / D
    if mode == "cold" or guess.path == "root":
        return True
    if "diverged" in (guess.path, prev.path):
        return False
    if guess == prev:
        if pp == 0 and np.isclose(f, 1.0):
            return False                    # the first attempt
        if mode.startswith("nsub"):
            return f <= 0.5 + 1e-12         # every chain converges
        if pp == 0 and f <= 0.25 + 1e-12:
            return True                     # the first continuation step
        if mode in ("damped_warm", "damped_cont", "fallback"):
            return np.isclose(f, 0.5)       # the nsub = 2 chain
        return False
    if guess.path.startswith("sub"):        # the full dt from a chain's end
        return mode == f"nsub{guess.path[3:]}"
    # continuation from its last root: steps of at most 0.3 D, reaching the
    # full dt only in its own mode
    gp = (guess.t - t0) / D
    reach = 1.0 if mode == "continuation" else 0.7
    return (guess.path == "part" and f - gp <= 0.3 + 1e-12
            and f <= reach + 1e-12)


def damped_ok(mode, guess):
    return ((mode == "damped_warm" and guess.path.startswith("sub"))
            or (mode == "damped_cont" and guess.path == "part"))


def newton_iters(mode, guess, prev, dt):
    if not newton_ok(mode, guess, prev, dt):
        return 7
    return 2 if guess == prev else 3


def solve_result(mode, guess, prev, dt):
    """(converged, x, Newton iterations)."""
    t0, D = step_frame(prev)
    it = newton_iters(mode, guess, prev, dt)
    if not newton_ok(mode, guess, prev, dt):
        return False, State(prev.t, "diverged"), it
    if not np.isclose(prev.t + dt, t0 + D):
        path = "part"
    elif guess == prev:
        path = "cold" if np.isclose(dt, D) else f"sub{int(round(D / dt))}"
    else:
        path = f"from-{guess.path}"
    return True, State(prev.t + dt, path), it


class ScriptedProblem:
    name = "scripted"
    csv_columns = ("time", "x", "path")
    abort_condition = None
    time = TimeConfig(dt0=1.0, dt_min=0.01, end_time=5.0)
    solver = SolverConfig(krylov_forcing="fixed")

    def initial_state(self, device=None):
        return State(0.0)


def observables(x):
    return [x.t, float(len(x.path))]


class Log:
    def __init__(self, modes):
        self.modes, self.calls = modes, []

    def mode(self, prev):
        k = int(np.searchsorted(GRID, prev.t + 1e-9))
        return self.modes[k], k


class JaxScripted:
    """The JAX package's runner interface: ``step`` returns (result with
    ``.x``, packed [iters, converged, krylov, |F|, *obs]);
    ``host_damped()(guess, prev, dt)`` returns (x, converged, |F|)."""

    def __init__(self, log):
        self.log = log

    def step(self, guess, prev, dt):
        mode, k = self.log.mode(prev)
        conv, x, it = solve_result(mode, guess, prev, dt)
        self.log.calls.append((k, "step", guess, prev, round(dt, 12)))
        packed = np.array([it, conv, 10 * it, 0.0 if conv else 1.0]
                          + observables(x))
        return types.SimpleNamespace(x=x), packed

    def host_damped(self):
        def solve(guess, prev, dt):
            mode, k = self.log.mode(prev)
            self.log.calls.append((k, "damped", guess, prev, round(dt, 12)))
            if damped_ok(mode, guess):
                return State(prev.t + dt, "root"), True, 0.0
            return guess, False, 1.0

        return solve


class TorchScripted:
    """The port's runner interface: ``step`` returns (NewtonResult-like,
    observables); ``host_damped()`` returns a ``DampedResult``."""

    device = "cpu"

    def __init__(self, log):
        self.log = log

    def step(self, guess, prev, dt):
        mode, k = self.log.mode(prev)
        conv, x, it = solve_result(mode, guess, prev, dt)
        self.log.calls.append((k, "step", guess, prev, round(dt, 12)))
        res = types.SimpleNamespace(x=x, converged=conv, iters=it,
                                    krylov_iters=10 * it,
                                    res_norm=0.0 if conv else 1.0)
        return res, observables(x)

    def host_damped(self):
        def solve(guess, prev, dt):
            mode, k = self.log.mode(prev)
            self.log.calls.append((k, "damped", guess, prev, round(dt, 12)))
            if damped_ok(mode, guess):
                return DampedResult(State(prev.t + dt, "root"), True, 0.0, 4, 40)
            return DampedResult(guess, False, 1.0, 40, 400)

        return solve


def without_fallback_resolves(calls):
    """The JAX calls less the fallback's dt/2 substeps: those after a
    step's last damped call that start from their own previous state."""
    out = []
    for k in sorted({c[0] for c in calls}):
        step = [c for c in calls if c[0] == k]
        damped = [i for i, c in enumerate(step) if c[1] == "damped"]
        if damped:
            last = damped[-1]
            step = step[:last + 1] + [c for c in step[last + 1:]
                                      if not (c[1] == "step" and c[2] == c[3])]
        out += step
    return out


# expected rung of step 2 for each mode
RUNGS = {"cold": "", "nsub2": "substep2", "nsub4": "substep4",
         "nsub8": "substep8", "continuation": "continuation",
         "damped_warm": "damped from warm",
         "damped_cont": "damped from continuation", "fallback": "2x(dt/2)",
         "partial": None}


@pytest.mark.parametrize("mode", list(RUNGS))
def test_ladder_matches_jax_timeloop(mode):
    modes = ["cold", mode, "cold", "cold"]
    jlog, tlog = Log(modes), Log(modes)
    ref = jax_timeloop.run(ScriptedProblem(), time_grid=GRID,
                           replay_partial=True, replay_substep_fallback=True,
                           verbose=False, _runner=JaxScripted(jlog))
    got = timeloop.run(ScriptedProblem(), device="cpu", time_grid=GRID,
                       replay_partial=True, verbose=False,
                       _runner=TorchScripted(tlog))

    assert tlog.calls == without_fallback_resolves(jlog.calls)
    assert got.rows.shape == ref.rows.shape
    np.testing.assert_array_equal(got.rows, ref.rows)
    assert got.state == ref.state
    assert [s.retries for s in got.stats] == [s.retries for s in ref.stats]
    assert ([s.newton_iters for s in got.stats]
            == [s.newton_iters for s in ref.stats])
    assert ([s.krylov_iters for s in got.stats]
            == [s.krylov_iters for s in ref.stats])
    if RUNGS[mode] is None:
        assert len(got.rows) == 1          # replay_partial: stopped at step 2
        with pytest.raises(RuntimeError, match="did not converge"):
            timeloop.run(ScriptedProblem(), device="cpu", time_grid=GRID,
                         verbose=False, _runner=TorchScripted(Log(modes)))
    else:
        assert len(got.rows) == len(GRID)
        assert [s.rescue for s in got.stats] == ["", RUNGS[mode], "", ""]
        # every attempt and rung is counted, the damped rungs' own too
        newton = sum(newton_iters(mode, g, p, dt) if kind == "step"
                     else (4 if damped_ok(mode, g) else 40)
                     for k, kind, g, p, dt in tlog.calls if k == 1)
        assert got.stats[1].newton_iters_all == newton


# ---- (b) bench1 replay at 32^2 ----------------------------------------------

def test_bench1_replay_matches_jax():
    grid = np.loadtxt("results/bench1_replay.csv", delimiter=",",
                      skiprows=1)[:6, 0]
    pj = make_jax1(nx=32, ny=32, Lx=64.0, Ly=64.0)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=8, gmg_dense_coarse_max_dofs=0))
    ref = jax_timeloop.run(pj, time_grid=grid, replay_partial=True,
                           replay_substep_fallback=True, verbose=False)
    pt = make_torch1(nx=32, ny=32, Lx=64.0, Ly=64.0,
                     solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                     time=time_config_from_dict(dataclasses.asdict(pj.time)))
    got = timeloop.run(pt, device="cpu", time_grid=grid, replay_partial=True,
                       verbose=False)

    assert len(got.rows) == len(ref.rows) == 6
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    np.testing.assert_allclose(got.rows[:, 0], grid, rtol=1e-12)
    assert ([s.newton_iters for s in got.stats]
            == [s.newton_iters for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-7
    assert sol_rel.max() <= 1e-9


# ---- (c) damped Newton ---------------------------------------------------

def test_damped_newton_matches_jax():
    dt = 1.0
    pj = make_jax3(nx=70, ny=70)
    pt = make_torch3(nx=70, ny=70,
                     solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                     time=time_config_from_dict(dataclasses.asdict(pj.time)))
    w0 = pt.initial_state("cpu")
    # the full-step Newton fails here
    assert not timeloop.Runner(pt, "cpu").step(w0, w0, dt)[0].converged

    # the JAX solver builds a preconditioner once per iteration, inside its
    # jitted linear solve: count the builds as they run
    builds = []
    build = pj.precond_builder()

    def counted_build(x, w_prev, dt_):
        jax.debug.callback(lambda: builds.append(1))
        return build(x, w_prev, dt_)

    shim = types.SimpleNamespace(solver=pj.solver, residual=pj.residual,
                                 residual_lowp=pj.residual_lowp,
                                 precond_builder=lambda: counted_build)
    w0j = pj.initial_state()
    xj, conv_j, _ = jax_damped_newton(shim)(w0j, w0j, dt)
    out = make_host_damped_newton(pt, "cpu")(w0, w0, dt)

    assert out.converged and bool(conv_j)
    # the JAX loop builds once more at the root, where it stops
    assert out.iters == len(builds) - 1
    for a, b in zip(out.x, xj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)


# ---- (d) the CLI ----------------------------------------------------------

def test_cli_replay(tmp_path):
    out = tmp_path / "r.csv"
    main("bench1", ["--replay", "results/bench1_replay.csv", "--device", "cpu",
                    "--nx", "16", "--ny", "16", "--max-steps", "3", "--quiet",
                    "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    grid = np.loadtxt("results/bench1_replay.csv", delimiter=",",
                      skiprows=1)[:3, 0]
    assert rows.shape == (3, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], grid, rtol=1e-12)
