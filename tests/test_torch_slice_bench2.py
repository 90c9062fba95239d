"""The port's bench2 slice end to end on the CPU against the JAX package's
``timeloop.run``: bench2 at 16^2 (L = 200, six fields), 3 adaptive steps,
with the field-split V-cycle over levels 16/8/4 (``gmg_min_cells`` 4), per
group LMR step lengths, the dunavant1 hierarchy and the coarsest level
solved by 8 LMR sweeps (``gmg_dense_coarse_max_dofs`` 0), as the 25^2
level is at 100^2. The JAX package runs the same cycle as its XLA V-cycle
on the CPU. The time grid and the Newton counts must be identical (they
drive the dt controller), TFE rel <= 1e-7, solute rel <= 1e-10, Krylov
counts within 3 (or 3%) per step. Also the bench2 CLI at 16^2 for 2
steps."""

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)


def test_bench2_slice_matches_jax_timeloop():
    pj = make_jax(nx=16, ny=16)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=4, gmg_dense_coarse_max_dofs=0))
    assert pj.solver.field_split and pj.solver.gmg_coarse_sweeps == 8
    ref = jax_timeloop.run(pj, max_steps=3, verbose=False)

    pt = make_torch(nx=16, ny=16,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    assert [g.nx for g in pt.precond_builder("cpu").grids] == [16, 8, 4]
    got = timeloop.run(pt, device="cpu", max_steps=3, verbose=False)

    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-7
    assert sol_rel.max() <= 1e-10
    for a, b in zip(got.stats, ref.stats):
        kj = int(b.krylov_iters)
        assert abs(a.krylov_iters - kj) <= max(3, 0.03 * kj)


def test_bench2_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b2.csv"
    main("bench2", ["--device", "cpu", "--nx", "16", "--ny", "16",
                    "--max-steps", "2", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.01, 0.03])
