"""The port's linear validation problems through ``timeloop.run`` on the CPU,
against the JAX package's ``timeloop.run``, and what the f64 linear branch
still refuses:

- poisson 16^2, poisson3d 8^3 and elast 50 x 10 with Lx 5 (the sizes of
  ``tests/data/linear_jax_rows.json``'s reduced rows): the time column and
  the Newton counts equal, the observables within rel 1e-8, the state on the
  requested device in f64;
- the port's own O(h^2) L2 rates, poisson at 8/16/32 (1.8-2.3) and poisson3d
  at 12/24 (1.7-2.4), the bounds of tests/test_manufactured.py;
- the invariants of ``tests/data/linear_jax_rows.json``
  (tools/jax_linear_rows.py): elast's strain energy to the printed digits of
  ``results/elast_out.csv`` and its tip deflection within rel 1e-6 of it
  (the CSV's tip is the TPU run's; the JAX package's CPU run differs from
  it by 2.5e-9), poisson's L2 rate from its 16^2 and 64^2 rows, one Newton
  iteration each;
- the refusals: GMG in f64, ``dense_impl='mxu'``, mixed precision without a
  kernel J.v, ``bench1_periodic``; the CLI of the three on the CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.registry import \
    get_benchmark as jax_get_benchmark
from pfhubbenchmarks_tpu_torch import config, timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark, main
from pfhubbenchmarks_tpu_torch.io.csvout import read_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = os.path.join(REPO, "tests", "data", "linear_jax_rows.json")

SLICES = {
    "poisson": {"nx": 16, "ny": 16},
    "poisson3d": {"nx": 8, "ny": 8, "nz": 8},
    "elast": {"nx": 50, "ny": 10, "Lx": 5.0},
}


@pytest.mark.parametrize("name", sorted(SLICES))
def test_slice_matches_jax_timeloop(name):
    kwargs = SLICES[name]
    assert jax.config.read("jax_enable_x64")
    ref = jax_timeloop.run(jax_get_benchmark(name, **kwargs), verbose=False)
    got = timeloop.run(get_benchmark(name, **kwargs), device="cpu",
                       verbose=False)
    assert tuple(got.columns) == tuple(ref.columns)
    np.testing.assert_array_equal(got.rows[:, 0], np.asarray(ref.rows)[:, 0])
    assert ([s.newton_iters for s in got.stats]
            == [int(s.newton_iters) for s in ref.stats] == [1])
    np.testing.assert_allclose(got.rows[:, 1:], np.asarray(ref.rows)[:, 1:],
                               rtol=1e-8, atol=0)
    assert all(t.device.type == "cpu" and t.dtype == torch.float64
               for t in got.state)


def _l2(name, n):
    kwargs = {"nx": n, "ny": n} | ({"nz": n} if name == "poisson3d" else {})
    result = timeloop.run(get_benchmark(name, **kwargs), device="cpu",
                          verbose=False)
    assert [s.newton_iters for s in result.stats] == [1]
    return float(np.sqrt(result.rows[0, 1]))


def test_poisson_rates_are_second_order():
    errs = [_l2("poisson", n) for n in (8, 16, 32)]
    rates = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert errs[-1] < 2e-3
    assert all(1.8 < r < 2.3 for r in rates), (errs, rates)


def test_poisson3d_rate_is_second_order():
    errs = [_l2("poisson3d", n) for n in (12, 24)]
    rate = np.log2(errs[0] / errs[1])
    assert errs[-1] < 1e-4, errs
    assert 1.7 < rate < 2.4, (errs, rate)


def test_jax_rows_file_invariants():
    with open(ROWS) as f:
        runs = json.load(f)["runs"]
    for run in runs.values():
        assert run["newton_iters"] == [1]
        assert len(run["rows"]) == 1 and run["rows"][0][0] == 1.0
    rows, cols = read_csv(os.path.join(REPO, "results", "elast_out.csv"))
    elast = runs["elast 250x10"]
    assert cols == elast["columns"]
    # '%1.10f': the strain energy to half a unit of its last printed digit
    assert abs(elast["rows"][0][1] - rows[0, 1]) <= 5e-11
    # the CSV's tip (-5.2967541e-3) is the TPU run's; the JAX package's CPU
    # run gives -5.29675162e-3
    assert abs(elast["rows"][0][2] / rows[0, 2] - 1.0) <= 1e-6
    e16 = np.sqrt(runs["poisson 16x16"]["rows"][0][1])
    e64 = np.sqrt(runs["poisson 64x64"]["rows"][0][1])
    assert 1.95 < np.log2(e16 / e64) / 2.0 < 2.05


def test_unported_linear_configurations_raise():
    poisson = get_benchmark("poisson", nx=4, ny=4)
    gmg64 = dataclasses.replace(poisson, solver=dataclasses.replace(
        poisson.solver, precond="gmg"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        gmg64.precond_builder("cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        config.check_supported(gmg64.solver)
    p3 = get_benchmark("poisson3d", nx=4, ny=4, nz=4)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        dataclasses.replace(p3, solver=dataclasses.replace(
            p3.solver, precond="gmg")).precond_builder("cpu")
    elast = get_benchmark("elast", nx=4, ny=2)
    mxu = dataclasses.replace(elast, solver=dataclasses.replace(
        elast.solver, dense_impl="mxu"))
    with pytest.raises(NotImplementedError, match="mxu"):
        mxu.precond_builder("cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        config.check_supported(mxu.solver)
    # mixed precision needs a kernel J.v, and none is ported for these; it
    # does not fall back to torch.func
    for p in (poisson, p3, elast):
        mixed = dataclasses.replace(p, solver=dataclasses.replace(
            p.solver, mixed_precision=True))
        assert mixed.kernel_jvp is None
        with pytest.raises(NotImplementedError, match="kernel J.v"):
            mixed.lowp_jvp_factory("cpu")
        assert p.lowp_jvp_factory("cpu") is None
    with pytest.raises(ValueError, match="not yet ported"):
        get_benchmark("bench1_periodic")


def test_cli_runs_the_linear_problems_on_the_cpu(tmp_path):
    for name, args in (("poisson", ["--nx", "8", "--ny", "8"]),
                       ("poisson3d", ["--nx", "4", "--ny", "4", "--nz", "4"]),
                       ("elast", ["--nx", "10", "--ny", "2"])):
        out = tmp_path / f"{name}.csv"
        main(name, ["--device", "cpu", "--quiet", "--out", str(out)] + args)
        rows, cols = read_csv(str(out))
        assert rows.shape == (1, 3) and rows[0, 0] == 1.0
        assert np.isfinite(rows).all()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main("elast", ["--nx", "10", "--ny", "2"])
