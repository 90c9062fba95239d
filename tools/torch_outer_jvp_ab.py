"""The box kernels against the gather kernels they replace, end to end, on
the card: a benchmark's main path with its outer J.v and exported A z as
kernel W (``BenchmarkProblem.outer_jvp_form`` "box", the main path of
bench1, bench2 and bench3) and with the f32 residual of its cp line search
as the residual box (``residual_form`` "box", bench2 and bench6), against
the same path with the gather kernels (A at BM1, F at BM2, G at BM3; R),
in turns box, gather, gather, box per round, in one process on one card,
so that the host's speed reaches both alike. ``--part`` says which forms
the two runs differ in: ``jvp`` the outer J.v, ``residual`` the residual,
``all`` both (the others keep the problem's own form). Prints each run's
wall, Krylov iterations over all attempts, ms per Krylov iteration and the
launches, then the medians; the time columns and counts of the two forms
must be equal (the boxes compute the gather kernels' bits).

    python3 tools/torch_outer_jvp_ab.py [--bench bench2] [--part all]
                                        [--rows N] [--rounds 1]

``--rows`` cuts the run to its first N rows (default: the whole run). On the
card only (``torch.cuda.is_available()``); a first short run of each form
after the kernels' build is a warm-up and is not counted.
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


def with_forms(problem, part: str, form: str):
    """``problem`` with the forms of ``part`` ("jvp", "residual" or "all")
    set to ``form`` where the problem runs them as boxes."""
    kw = {}
    if part in ("jvp", "all") and problem.outer_jvp_form == "box":
        kw["outer_jvp_form"] = form
    if part in ("residual", "all") and problem.residual_form == "box":
        kw["residual_form"] = form
    if not kw:
        raise SystemExit(f"{problem.name} runs no box form of {part!r}")
    return dataclasses.replace(problem, **kw)


def run(problem, dev, rows, part: str, form: str) -> dict:
    """``problem``'s main path, its first ``rows`` steps (all if None), with
    the forms of ``part`` set to ``form``."""
    runner = timeloop.Runner(with_forms(problem, part, form), dev)
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
    ap.add_argument("--bench", default="bench2")
    ap.add_argument("--part", choices=("jvp", "residual", "all"), default="all")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_outer_jvp_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}", flush=True)
    problem = get_benchmark(args.bench)
    for form in ("box", "gather"):   # warm-up: build, first launches
        run(problem, dev, 2, args.part, form)
    runs = []
    for _ in range(args.rounds):
        for form in ("box", "gather", "gather", "box"):
            r = run(problem, dev, args.rows, args.part, form)
            runs.append(r)
            print(f"{args.bench} {len(r['times'])} rows, {args.part} {form}: "
                  f"wall {r['wall']:.3f} s, krylov_all {r['krylov']}, "
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
    for form in ("box", "gather"):
        mine = [r for r in runs if r["form"] == form]
        med[form] = statistics.median(r["wall"] for r in mine)
        print(f"{args.bench} {len(ref['times'])} rows, {form}: median wall "
              f"{med[form]:.3f} s, median "
              f"{statistics.median(r['ms_per_krylov'] for r in mine):.4f} ms "
              f"per Krylov iteration over {len(mine)} runs", flush=True)
    print(f"{args.bench} ({args.part}): time columns and counts equal; box - "
          f"gather {med['box'] - med['gather']:+.3f} s of median wall",
          flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
