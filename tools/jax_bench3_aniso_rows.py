"""Gate rows of bench3's anisotropic configuration, from the JAX package.

No reference CSV of an anisotropic BM3 run exists (the FEniCS reference
authored a(theta) and switched it off, dolfin/bench3.py:72-81), so the JAX
package's own run is the gate the PyTorch port is held to. This script runs
``pfhubbenchmarks_tpu.benchmarks.bench3.make(anisotropy=True)`` at its
published size (350^2, the JAX package's solver configuration verbatim)
through ``timeloop.run`` on the CPU in float64, and writes

  tests/data/bench3_aniso_jax_rows.csv   the first rows in the reference
                                         schema (time, total_free_energy,
                                         solid_fraction; '%1.10f')
  tests/data/bench3_aniso_jax_rows.json  each row's Newton and Krylov
                                         counts, the residual norms of its
                                         Newton iterations (the accepted
                                         attempt's), the rows at full
                                         precision, the step walls and the
                                         total wall

It stops after ``--max-rows`` rows, or after the first row that ends past
``--budget-s`` seconds of wall (``write_rows``, which
tools/jax_bench6_3d_rows.py shares).

Run: JAX_PLATFORMS=cpu python tools/jax_bench3_aniso_rows.py \
         [--budget-s 900] [--max-rows 40] [--nx 350]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DATA = os.path.join(ROOT, "tests", "data")


class _Stop(Exception):
    pass


def write_rows(problem, out: str, source: str, budget_s: float,
               max_rows: int) -> None:
    """Run ``problem`` through the JAX package's ``timeloop.run`` (x64 on)
    until its end, ``max_rows`` rows, or the first row that ends past
    ``budget_s`` seconds of wall, and write ``out``.csv (the rows) and
    ``out``.json (counts, Newton norms, rows, walls, ``source``)."""
    from pfhubbenchmarks_tpu import timeloop
    from pfhubbenchmarks_tpu.io.csvout import write_csv

    runner = timeloop.Runner(problem)
    inner = runner.step
    last = []

    def step(*a):
        res, pk = inner(*a)
        last[:] = [float(h) for h in np.asarray(res.norm_hist)
                   if np.isfinite(h)]
        return res, pk

    runner.step = step
    rows, newton, krylov, walls, hists = [], [], [], [], []
    t0 = time.time()

    def on_step(stats, state):
        rows.append([float(v) for v in stats.row])
        newton.append(int(stats.newton_iters))
        krylov.append(int(stats.krylov_iters))
        walls.append(float(stats.wall))
        hists.append(list(last))
        print(f"row {len(rows)}: t={stats.row[0]:.6g} newton={newton[-1]} "
              f"krylov={krylov[-1]} wall={walls[-1]:.1f} s "
              f"(total {time.time() - t0:.1f} s)", flush=True)
        if len(rows) >= max_rows or time.time() - t0 > budget_s:
            raise _Stop

    complete = True
    try:
        timeloop.run(problem, verbose=False, on_step=on_step, _runner=runner)
    except _Stop:
        complete = False
    wall = time.time() - t0
    write_csv(out + ".csv", np.asarray(rows), problem.csv_columns)
    with open(out + ".json", "w") as f:
        json.dump({"source": source, "complete": complete,
                   "columns": list(problem.csv_columns),
                   "newton_iters": newton, "krylov_iters": krylov,
                   "newton_norms": hists,
                   "newton_atol": problem.solver.newton_atol,
                   "newton_rtol": problem.solver.newton_rtol,
                   "krylov_max_iters": problem.solver.krylov_max_iters,
                   "rows": rows, "step_wall_s": walls,
                   "wall_s": wall}, f, indent=1)
    print(f"{len(rows)} rows ({'the whole run' if complete else 'cut'}) in "
          f"{wall:.1f} s -> {out}.csv/.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--budget-s", type=float, default=900.0)
    ap.add_argument("--max-rows", type=int, default=40)
    ap.add_argument("--nx", type=int, default=350)
    ap.add_argument("--out", default=os.path.join(DATA, "bench3_aniso_jax_rows"))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from pfhubbenchmarks_tpu.config import enable_x64

    enable_x64()
    from pfhubbenchmarks_tpu.benchmarks.bench3 import make

    write_rows(make(nx=args.nx, ny=args.nx, anisotropy=True), args.out,
               "pfhubbenchmarks_tpu.benchmarks.bench3.make("
               f"nx={args.nx}, ny={args.nx}, anisotropy=True), timeloop.run on "
               "the CPU, float64", args.budget_s, args.max_rows)


if __name__ == "__main__":
    main()
