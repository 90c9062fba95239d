"""The port's bench1_3d slice end to end on the CPU against the JAX
package's ``timeloop.run``: bench1_3d at 20^3 (L = 100), 3 adaptive steps,
with the JAX package's configuration verbatim: the hierarchy 20/10/5 at
keast2 (ratio 2 twice), the K-cycle 3 on 10^3, the exact dense 5^3 coarse
solve (432 dofs), ``fast_residual``, basic line search. The JAX package runs
the same cycle on its XLA path on the CPU. The time grid and the Newton
counts must be identical (they drive the dt controller), TFE rel <= 1e-9;
the Krylov counts are printed, not asserted (ROADMAP Queue 3 item 1)."""

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench1_3d import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               time_config_from_dict)


def test_bench1_3d_slice_matches_jax_timeloop():
    pj = make_jax(nx=20, ny=20, nz=20)
    ref = jax_timeloop.run(pj, max_steps=3, verbose=False)

    pt = make_torch(nx=20, ny=20, nz=20,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    assert pt.solver.fast_residual and pt.solver.gmg_kcycle == 3
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [20, 10, 5] and build.dense_coarse
    got = timeloop.run(pt, device="cpu", max_steps=3, verbose=False)

    print("krylov per step: port", [s.krylov_iters for s in got.stats],
          "jax", [int(s.krylov_iters) for s in ref.stats])
    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-9
    assert sol_rel.max() <= 1e-12
