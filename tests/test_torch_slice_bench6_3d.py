"""The port's bench6_3d slice end to end on the CPU against the JAX
package's ``timeloop.run``: bench6_3d at 10^3 (L = 100), 4 adaptive steps,
with the JAX package's configuration verbatim: the hierarchy 10/5 at ffc3,
the exact dense 5^3 coarse solve (648 dofs) over the residual with its BC
rows, the cp line search, at most 300 Krylov iterations; phi = 0 on the
x = 0 face and sin(y/7) on the x = L face. The JAX package runs the same
cycle on its XLA path on the CPU (its Pallas kernels take no BC rows). The
time grid and the Newton counts must be identical (they drive the dt
controller), TFE rel <= 1e-8, solute rel <= 1e-10, and phi on its faces
equal to g to 1e-12; the Krylov counts are printed, not asserted (ROADMAP
Queue 3 item 1).

The committed rows of the JAX package's whole 20^3 run and of the first 50^3
rows (``tests/data/bench6_3d_jax_rows_20``, ``bench6_3d_jax_rows``;
tools/jax_bench6_3d_rows.py), which chip_smoke.py holds the card's runs to,
are checked for the invariants the card's runs are held to on them."""

import json
import os

import numpy as np
import pytest

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench6_3d import make as make_jax
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench6_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.io.csvout import read_csv

DATA = os.path.join(os.path.dirname(__file__), "data")


def test_bench6_3d_slice_matches_jax_timeloop():
    pj = make_jax(nx=10, ny=10, nz=10)
    ref = jax_timeloop.run(pj, max_steps=4, verbose=False)

    pt = make_torch(nx=10, ny=10, nz=10)
    s = pt.solver
    assert (s.line_search, s.krylov_max_iters, s.precond_rule) == ("cp", 300,
                                                                  None)
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [10, 5] and build.dense_coarse
    got = timeloop.run(pt, device="cpu", max_steps=4, verbose=False)

    print("krylov per step: port", [s.krylov_iters for s in got.stats],
          "jax", [int(s.krylov_iters) for s in ref.stats])
    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sol_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-8
    assert sol_rel.max() <= 1e-10
    (v,) = got.state
    for bc in pt.dirichlet:
        np.testing.assert_allclose(bc.rows(v).numpy(), bc.g[:11, :11],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("name, n, whole", [("bench6_3d_jax_rows_20", 20, True),
                                             ("bench6_3d_jax_rows", 50, False)])
def test_committed_jax_rows_conserve_and_start_from_the_ports_ic(name, n, whole):
    """The JAX package's gate rows (tools/jax_bench6_3d_rows.py): the 20^3
    file the whole run to t >= 3, the 50^3 file its first rows; each with its
    counts, every solve under the Krylov cap, TFE decreasing, the solute
    conserved, and the port's IC at that size carrying the row-1 solute."""
    rows, cols = read_csv(os.path.join(DATA, name + ".csv"))
    with open(os.path.join(DATA, name + ".json")) as f:
        gate = json.load(f)
    assert cols == ["time", "total_free_energy", "total_solute"]
    assert gate["complete"] == whole and (rows[-1, 0] >= 3.0) == whole
    assert len(gate["newton_iters"]) == len(gate["krylov_iters"]) == len(rows)
    assert len(rows) >= 3
    # a row's count sums its Newton iterations' solves, each under the cap
    assert gate["krylov_max_iters"] == 300
    assert all(k < 300 * n_it for k, n_it in zip(gate["krylov_iters"],
                                                 gate["newton_iters"]))
    full = np.asarray(gate["rows"])
    np.testing.assert_allclose(rows, full, rtol=1e-9, atol=1e-9)
    assert np.all(np.diff(full[:, 1]) < 0)
    assert np.max(np.abs(full[:, 2] / full[0, 2] - 1.0)) <= 1e-10
    pt = make_torch(nx=n, ny=n, nz=n)
    sol = float(pt.observable_fns("cpu")["total_solute"](
        pt.initial_state("cpu")))
    assert abs(sol / full[0, 2] - 1.0) <= 1e-10
