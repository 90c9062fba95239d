"""The V-cycle's chain kernels against their launch sequences, end to end, on
the card: a benchmark's main path for its first rows with the descend and
ascend chains as one launch each (``kernel``: ``vcycle_descend_chain``,
``vcycle_ascend_chain``, the main path) and as the loop of launches per level
they replace (``sequence``: L, D or H and the level J.v per level), in turns
kernel, sequence, sequence, kernel per round, in one process on one card, so
that the host's speed reaches both alike. Prints each run's wall, Krylov
iterations over all attempts, ms per Krylov iteration and the multigrid
builds' seconds, then the medians; the time columns and counts of the two
routes must be equal (the chain kernels compute the sequence's bits).

    python3 tools/torch_chain_ab.py [--bench bench1] [--rows 30] [--rounds 2]

On the card only (``torch.cuda.is_available()``); the first run of each route
after the kernels' build is a warm-up and is not counted.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfhubbenchmarks_tpu_torch import timeloop  # noqa: E402
from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark  # noqa: E402
from pfhubbenchmarks_tpu_torch.ops import _lib, vcycle_chain  # noqa: E402


def run(problem, dev, rows: int, route: str) -> dict:
    """``rows`` steps of ``problem``'s main path with its chains built as
    ``route`` ("kernel": one launch each, "sequence": the loop of launches)."""
    one_launch = vcycle_chain.one_launch
    if route == "sequence":
        vcycle_chain.one_launch = lambda jvs: False
    try:
        runner = timeloop.Runner(problem, dev)
    finally:
        vcycle_chain.one_launch = one_launch
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = runner.run(max_steps=rows, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = result.stats
    krylov = sum(s.krylov_iters_all for s in st)
    return dict(route=route, wall=wall, krylov=krylov,
                ms_per_krylov=wall / max(krylov, 1) * 1e3,
                builds=_lib.SECONDS["precond_build"],
                launches={k: n for k, n in {**_lib.LAUNCHES,
                                            **_lib.CALLS}.items() if n},
                times=result.rows[:, 0].copy(),
                newton=[s.newton_iters_all for s in st])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="bench1")
    ap.add_argument("--rows", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    problem = get_benchmark(args.bench)
    for route in ("kernel", "sequence"):   # warm-up: build, first launches
        run(problem, dev, 2, route)
    runs = []
    for _ in range(args.rounds):
        for route in ("kernel", "sequence", "sequence", "kernel"):
            r = run(problem, dev, args.rows, route)
            runs.append(r)
            print(f"{args.bench} {args.rows} rows, {route}: wall "
                  f"{r['wall']:.3f} s, krylov_all {r['krylov']}, "
                  f"{r['ms_per_krylov']:.3f} ms per Krylov iteration, builds "
                  f"{r['builds']:.3f} s, launches {r['launches']}", flush=True)
    ref = runs[0]
    for r in runs[1:]:
        if not (np.array_equal(r["times"], ref["times"])
                and r["newton"] == ref["newton"] and r["krylov"] == ref["krylov"]):
            raise AssertionError(f"{args.bench}: the {r['route']} run's time "
                                 "column or counts differ")
    for route in ("kernel", "sequence"):
        mine = [r for r in runs if r["route"] == route]
        print(f"{args.bench} {args.rows} rows, {route}: median wall "
              f"{statistics.median(r['wall'] for r in mine):.3f} s, median "
              f"{statistics.median(r['ms_per_krylov'] for r in mine):.3f} ms "
              f"per Krylov iteration, median wall less builds "
              f"{statistics.median(r['wall'] - r['builds'] for r in mine):.3f} "
              f"s over {len(mine)} runs", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
