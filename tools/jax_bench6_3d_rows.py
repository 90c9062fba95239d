"""Gate rows of bench6_3d, from the JAX package.

No reference CSV of a 3D electrochemistry run exists (the reference's
b63d.py is a 2D near-copy of bench6), and a thin-z run does not reproduce
bench6's trajectory: z-invariant data does not give a z-invariant discrete
solution on Kuhn tets with mixed Dirichlet/Neumann faces
(tests/test_golden.py:125-134). So the JAX package's own run is the gate the
PyTorch port is held to. This script runs
``pfhubbenchmarks_tpu.benchmarks.bench6_3d.make(nx=n, ny=n, nz=n)`` (the JAX
package's time and solver configurations verbatim) through ``timeloop.run``
on the CPU in float64, and writes

  <out>.csv   the rows in the reference schema (time, total_free_energy,
              total_solute; '%1.10f')
  <out>.json  each row's Newton and Krylov counts, the residual norms of its
              Newton iterations (the accepted attempt's), the rows at full
              precision, the step walls and the total wall

It stops at the run's end, after ``--max-rows`` rows, or after the first
row that ends past ``--budget-s`` seconds of wall
(tools/jax_bench3_aniso_rows.py ``write_rows``). The committed files:
``--n 20`` (the whole run) as ``tests/data/bench6_3d_jax_rows_20``, and
``--n 50`` (the published size, its first rows) as
``tests/data/bench6_3d_jax_rows``.

Run: JAX_PLATFORMS=cpu python tools/jax_bench6_3d_rows.py --n 20 \
         --out tests/data/bench6_3d_jax_rows_20
     JAX_PLATFORMS=cpu python tools/jax_bench6_3d_rows.py --n 50 \
         --budget-s 1800
"""

from __future__ import annotations

import argparse
import os
import sys

from jax_bench3_aniso_rows import DATA, ROOT, write_rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=50, help="cells per axis")
    ap.add_argument("--budget-s", type=float, default=1800.0)
    ap.add_argument("--max-rows", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(DATA, "bench6_3d_jax_rows"))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from pfhubbenchmarks_tpu.config import enable_x64

    enable_x64()
    from pfhubbenchmarks_tpu.benchmarks.bench6_3d import make

    n = args.n
    write_rows(make(nx=n, ny=n, nz=n), args.out,
               "pfhubbenchmarks_tpu.benchmarks.bench6_3d.make("
               f"nx={n}, ny={n}, nz={n}), timeloop.run on the CPU, float64",
               args.budget_s, args.max_rows)


if __name__ == "__main__":
    main()
