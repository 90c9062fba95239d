"""The port's bench1 slice end to end on the CPU against the JAX package's
``timeloop.run``: bench1 at 32^2 (L = 64, GMG levels 32/16/8 with sweep
coarse solve), 4 adaptive steps. The time grid and the Newton counts must be
identical (they drive the dt controller), TFE rel <= 1e-7, solute rel <=
1e-10, Krylov counts within +-1. The same with ``fast_residual``, the cp line
search and ``fast_linesearch=False``, whose line search reads the staged
f32 residual; and in the tiled configuration at 40^2. Also the CLI at 16^2
for 2 steps."""

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)
from pfhubbenchmarks_tpu_torch.solve.newton import make_newton_solver


def test_slice_matches_jax_timeloop():
    pj = make_jax(nx=32, ny=32, Lx=64.0, Ly=64.0)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=8, gmg_dense_coarse_max_dofs=0))
    ref = jax_timeloop.run(pj, max_steps=4, verbose=False)

    pt = make_torch(nx=32, ny=32, Lx=64.0, Ly=64.0,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    got = timeloop.run(pt, device="cpu", max_steps=4, verbose=False)

    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [s.newton_iters for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-7
    assert sol_rel.max() <= 1e-10
    for a, b in zip(got.stats, ref.stats):
        assert abs(a.krylov_iters - b.krylov_iters) <= 1


def test_tiled_slice_matches_jax_timeloop():
    """The tiled configuration (``tiled_grid_kernels=True``): the outer J.v
    by T10 and the 40^2 level by T12 and the tiled sweep loop (plain
    versions on this CPU), against the JAX package's same run. At 40^2, not
    32^2: a 32^2 grid is one row block of 32, which the tiled configuration
    leaves to the gather kernels; 40^2 has two blocks of 20."""
    pj = make_jax(nx=40, ny=40, Lx=80.0, Ly=80.0)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=8, gmg_dense_coarse_max_dofs=0,
        tiled_grid_kernels=True))
    ref = jax_timeloop.run(pj, max_steps=4, verbose=False)

    pt = make_torch(nx=40, ny=40, Lx=80.0, Ly=80.0,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    assert pt.precond_builder("cpu").tiled_levels == [True, False, False]
    got = timeloop.run(pt, device="cpu", max_steps=4, verbose=False)

    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [s.newton_iters for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    assert tfe_rel.max() <= 1e-7
    for a, b in zip(got.stats, ref.stats):
        assert abs(a.krylov_iters - b.krylov_iters) <= 1


def test_fast_residual_cp_linesearch_matches_jax():
    pj = make_jax(nx=32, ny=32, Lx=64.0, Ly=64.0)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=8, gmg_dense_coarse_max_dofs=0,
        fast_residual=True, line_search="cp", fast_linesearch=False))
    ref = jax_timeloop.run(pj, max_steps=3, verbose=False)

    pt = make_torch(nx=32, ny=32, Lx=64.0, Ly=64.0,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    got = timeloop.run(pt, device="cpu", max_steps=3, verbose=False)

    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [s.newton_iters for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    assert tfe_rel.max() <= 1e-7

    # one Newton solve: the f32 residual is read once for the noise floor,
    # then per iteration by the cp line search and by the staged residual
    lowp_calls = []
    res_lp = pt.residual_lowp("cpu")

    def counting(*args):
        lowp_calls.append(1)
        return res_lp(*args)

    solve = make_newton_solver(pt.residual("cpu"), pt.solver,
                               pt.precond_builder("cpu"),
                               lowp_jvp_factory=pt.lowp_jvp_factory("cpu"),
                               residual_lowp=counting)
    w0 = pt.initial_state("cpu")
    out = solve(w0, w0, pt.time.dt0)
    k = sum(np.isfinite(h) for h in out.norm_hist) - 1
    assert k >= 1 and len(lowp_calls) == 1 + 2 * k


def test_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b1.csv"
    main("bench1", ["--device", "cpu", "--nx", "16", "--ny", "16",
                    "--max-steps", "2", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.1, 0.3])
