"""Kernel V against the split apply it replaces, end to end, on the card: a
benchmark's main path with FGMRES's pair (z, A z) as one launch of V
(``fuse_vcycle`` "auto", the main path of bench1, bench2 and bench2_eta1)
against the same path with the split apply (``fuse_vcycle`` "split_chain":
the descend chain, kernel L on the coarsest level, the ascend chain and the
exported J.v, kernel W), in turns fused, split, split, fused per round, in
one process on one card, so that the host's speed reaches both alike.
Prints each run's wall, Krylov iterations over all attempts, ms per Krylov
iteration and the launches, then the medians and the spread of each form;
the time columns and counts of the two forms must be equal (V computes the
split apply's bits).

    python3 tools/torch_vcycle_ab.py [--bench bench1] [--rows N]
                                     [--rounds 1]

``--rows`` cuts the run to its first N rows (default: the whole run). On the
card only; a first short run of each form after the kernels' build is a
warm-up and is not counted.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from pfhubbenchmarks_tpu_torch.ops import _lib  # noqa: E402

FORMS = {"fused": "auto", "split": "split_chain"}


def run(problem, dev, rows, form: str) -> dict:
    """``problem``'s main path, its first ``rows`` steps (all if None), with
    ``fuse_vcycle`` of ``form``."""
    problem = dataclasses.replace(problem, solver=dataclasses.replace(
        problem.solver, fuse_vcycle=FORMS[form]))
    runner = timeloop.Runner(problem, dev)
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = runner.run(max_steps=rows, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = result.stats
    krylov = sum(s.krylov_iters_all for s in st)
    return dict(form=form, wall=wall, krylov=krylov,
                ms_per_krylov=wall / max(krylov, 1) * 1e3,
                launches={k: n for k, n in _lib.LAUNCHES.items() if n},
                times=result.rows[:, 0].copy(),
                newton=[s.newton_iters_all for s in st],
                krylov_steps=[s.krylov_iters_all for s in st])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="bench1")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_vcycle_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    problem = get_benchmark(args.bench)
    for form in FORMS:   # warm-up: build, first launches
        run(problem, dev, 2, form)
    runs = []
    for _ in range(args.rounds):
        for form in ("fused", "split", "split", "fused"):
            r = run(problem, dev, args.rows, form)
            runs.append(r)
            print(f"{args.bench} {len(r['times'])} rows, {form}: wall "
                  f"{r['wall']:.3f} s, krylov_all {r['krylov']}, "
                  f"{r['ms_per_krylov']:.4f} ms per Krylov iteration, "
                  f"launches {r['launches']}", flush=True)
    ref = runs[0]
    for r in runs[1:]:
        if not (np.array_equal(r["times"], ref["times"])
                and r["newton"] == ref["newton"]
                and r["krylov_steps"] == ref["krylov_steps"]):
            raise AssertionError(f"{args.bench}: the {r['form']} run's time "
                                 "column or counts differ")
    med = {}
    for form in FORMS:
        walls = [r["wall"] for r in runs if r["form"] == form]
        med[form] = statistics.median(walls)
        print(f"{args.bench} {len(ref['times'])} rows, {form}: median wall "
              f"{med[form]:.3f} s (spread {min(walls):.3f}-{max(walls):.3f}), "
              f"median {statistics.median(r['ms_per_krylov'] for r in runs if r['form'] == form):.4f}"
              f" ms per Krylov iteration over {len(walls)} runs", flush=True)
    print(f"{args.bench}: time columns and counts equal; fused - split "
          f"{med['fused'] - med['split']:+.3f} s of median wall", flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
