"""The port's bench6 slice end to end on the CPU against the JAX package's
``timeloop.run``: bench6 at 16^2 (L = 100, three fields, Dirichlet phi),
4 adaptive steps, with the split_chain cycle over levels 16/8/4
(``gmg_min_cells`` 4), the coarsest level solved by LMR sweeps
(``gmg_dense_coarse_max_dofs`` 0; 8 sweeps to keep the CPU run short), cp
line search and the lagged preconditioner. The JAX package runs the same
cycle as its XLA V-cycle on the CPU. The time grid and the Newton counts
must be identical (they drive the dt controller), TFE rel <= 1e-7, solute
rel <= 1e-10, Krylov counts within +-1 per step. Also the bench6 CLI at
16^2 for 2 steps."""

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)


def test_bench6_slice_matches_jax_timeloop():
    pj = make_jax(nx=16, ny=16)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=4, gmg_dense_coarse_max_dofs=0,
        gmg_coarse_sweeps=8))
    ref = jax_timeloop.run(pj, max_steps=4, verbose=False)

    pt = make_torch(nx=16, ny=16,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    assert [g.nx for g in pt.precond_builder("cpu").grids] == [16, 8, 4]
    got = timeloop.run(pt, device="cpu", max_steps=4, verbose=False)

    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-7
    assert sol_rel.max() <= 1e-10
    for a, b in zip(got.stats, ref.stats):
        assert abs(a.krylov_iters - int(b.krylov_iters)) <= 1
    # the Dirichlet values hold in the final state
    v = got.state[0]
    for bc in pt.dirichlet:
        np.testing.assert_array_equal(bc.rows(v).numpy(), bc.g)


def test_bench6_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b6.csv"
    main("bench6", ["--device", "cpu", "--nx", "16", "--ny", "16",
                    "--max-steps", "2", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.01, 0.03])
