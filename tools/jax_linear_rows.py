"""Gate rows of the linear validation problems, from the JAX package.

poisson, poisson3d and elast are steady linear problems: one time step, one
row at t = 1.0. elast's published row is ``results/elast_out.csv``, printed
to 6 and 8 digits; poisson and poisson3d have no reference CSV. This script
runs the JAX package's ``timeloop.run`` on the CPU in float64 for each
configuration below (the JAX package's ``make`` with the sizes given, its
time and solver configurations verbatim) and writes
``tests/data/linear_jax_rows.json``: per run the benchmark, its ``make``
arguments, the columns, the row at full precision, the Newton and Krylov
counts and the wall. The published sizes (poisson 64^2, poisson3d 32^3,
elast 250 x 10) gate ``chip_smoke.py``'s phases 34-36; the reduced ones are
the sizes the CPU tests run.

Run: JAX_PLATFORMS=cpu python tools/jax_linear_rows.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "linear_jax_rows.json")

# run label -> (benchmark, make arguments)
RUNS = {
    "poisson 64x64": ("poisson", {"nx": 64, "ny": 64}),
    "poisson 16x16": ("poisson", {"nx": 16, "ny": 16}),
    "poisson3d 32^3": ("poisson3d", {"nx": 32, "ny": 32, "nz": 32}),
    "poisson3d 8^3": ("poisson3d", {"nx": 8, "ny": 8, "nz": 8}),
    "elast 250x10": ("elast", {"nx": 250, "ny": 10}),
    "elast 50x10 Lx 5": ("elast", {"nx": 50, "ny": 10, "Lx": 5.0}),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from pfhubbenchmarks_tpu.config import enable_x64

    enable_x64()
    from pfhubbenchmarks_tpu import timeloop
    from pfhubbenchmarks_tpu.benchmarks.registry import get_benchmark

    runs = {}
    for label, (name, kwargs) in RUNS.items():
        t0 = time.time()
        result = timeloop.run(get_benchmark(name, **kwargs), verbose=False)
        wall = time.time() - t0
        runs[label] = {
            "benchmark": name, "make": kwargs,
            "columns": list(result.columns),
            "rows": [[float(v) for v in row] for row in result.rows],
            "newton_iters": [int(s.newton_iters) for s in result.stats],
            "krylov_iters": [int(s.krylov_iters) for s in result.stats],
            "wall_s": wall,
        }
        print(f"{label}: {runs[label]['rows']} newton "
              f"{runs[label]['newton_iters']} krylov "
              f"{runs[label]['krylov_iters']} ({wall:.1f} s)", flush=True)
    with open(args.out, "w") as f:
        json.dump({"source": "pfhubbenchmarks_tpu timeloop.run on the CPU, "
                             "float64 (tools/jax_linear_rows.py)",
                   "runs": runs}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
