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
``--budget-s`` seconds of wall.

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
    from pfhubbenchmarks_tpu import timeloop
    from pfhubbenchmarks_tpu.benchmarks.bench3 import make
    from pfhubbenchmarks_tpu.io.csvout import write_csv

    problem = make(nx=args.nx, ny=args.nx, anisotropy=True)
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
        if len(rows) >= args.max_rows or time.time() - t0 > args.budget_s:
            raise _Stop

    try:
        timeloop.run(problem, verbose=False, on_step=on_step, _runner=runner)
    except _Stop:
        pass
    wall = time.time() - t0
    write_csv(args.out + ".csv", np.asarray(rows), problem.csv_columns)
    with open(args.out + ".json", "w") as f:
        json.dump({"source": "pfhubbenchmarks_tpu.benchmarks.bench3.make("
                             f"nx={args.nx}, ny={args.nx}, anisotropy=True), "
                             "timeloop.run on the CPU, float64",
                   "columns": list(problem.csv_columns),
                   "newton_iters": newton, "krylov_iters": krylov,
                   "newton_norms": hists,
                   "newton_atol": problem.solver.newton_atol,
                   "newton_rtol": problem.solver.newton_rtol,
                   "rows": rows, "step_wall_s": walls,
                   "wall_s": wall}, f, indent=1)
    print(f"{len(rows)} rows in {wall:.1f} s -> {args.out}.csv/.json")


if __name__ == "__main__":
    main()
