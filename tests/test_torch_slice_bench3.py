"""The port's bench3 slice end to end on the CPU against the JAX package's
``timeloop.run``: bench3 at 70^2 (L = 960, fields U and phi), 3 adaptive
steps, with the JAX package's configuration verbatim: the hierarchy
70/35/7 (ratios 2 and 5: kernel D's and H's transfers), the exact dense
7^2 coarse solve (226 dofs), dunavant2 levels, nu 3/3 with one fine
pre-sweep, basic line search, ``krylov_atol_frac`` 0.1. The JAX package
runs the same cycle as its XLA V-cycle on the CPU. The time grid and the
Newton counts must be identical (they drive the dt controller), TFE rel
<= 1e-10, solid fraction rel <= 1e-9, Krylov counts within +-1 per step.
Also the bench3 CLI at 14^2 for 2 steps."""

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)


def test_bench3_slice_matches_jax_timeloop():
    pj = make_jax(nx=70, ny=70)
    ref = jax_timeloop.run(pj, max_steps=3, verbose=False)

    pt = make_torch(nx=70, ny=70,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [70, 35, 7] and build.dense_coarse
    got = timeloop.run(pt, device="cpu", max_steps=3, verbose=False)

    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sf_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-10
    assert sf_rel.max() <= 1e-9
    for a, b in zip(got.stats, ref.stats):
        assert abs(a.krylov_iters - int(b.krylov_iters)) <= 1


def test_bench3_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b3.csv"
    main("bench3", ["--device", "cpu", "--nx", "14", "--ny", "14",
                    "--max-steps", "2", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,solid_fraction"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.01, 0.03])
