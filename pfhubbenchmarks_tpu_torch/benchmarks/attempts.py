"""Every Newton solve attempt of a benchmark's run, as JSON: where two runs
of the same benchmark part ways.

    python -m pfhubbenchmarks_tpu_torch.benchmarks.attempts bench2 --rows 28 \
        [--residual kernel|einsum] [--device cuda|cpu] [--nx N --ny N] \
        [--out attempts.json]

For each attempt: its dt, Newton and Krylov counts, whether it converged,
the cp line search's step lengths and the residual norm per Newton
iteration. ``--residual einsum`` runs the f32 residual of the cp line search
as the f32 einsum assembly instead of kernel R (``kernel_residual=None``), so
two runs show which attempts R's rounding moves. Prints one line per
attempt and writes the list to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark
from pfhubbenchmarks_tpu_torch.solve import newton


def record_attempts(problem, device, rows: int) -> list[dict]:
    """Run ``problem`` for ``rows`` accepted steps; one dict per attempt."""
    lams, attempts = [], []
    cp_step = newton._cp_step

    def logged_cp(*args):
        lam = cp_step(*args)
        lams.append(lam)
        return lam

    runner = timeloop.Runner(problem, device)
    step = runner.step

    def logged_step(w_guess, w_prev, dt):
        lams.clear()
        res, obs = step(w_guess, w_prev, dt)
        attempts.append(dict(
            dt=dt, newton=res.iters, krylov=res.krylov_iters,
            converged=bool(res.converged), lam=list(lams),
            norms=[h for h in res.norm_hist if math.isfinite(h)]))
        return res, obs

    runner.step = logged_step
    newton._cp_step = logged_cp
    try:
        runner.run(max_steps=rows, verbose=False)
    finally:
        newton._cp_step = cp_step
    return attempts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("bench")
    ap.add_argument("--rows", type=int, required=True)
    ap.add_argument("--residual", choices=("kernel", "einsum"), default="kernel")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    size = {k: v for k, v in (("nx", args.nx), ("ny", args.ny)) if v}
    problem = get_benchmark(args.bench, **size)
    if args.residual == "einsum":
        problem = dataclasses.replace(problem, kernel_residual=None)
    attempts = record_attempts(problem, device, args.rows)
    for i, a in enumerate(attempts):
        print(json.dumps(dict(attempt=i, **a)), flush=True)
    print(f"{args.bench} ({args.residual} residual): {len(attempts)} attempts, "
          f"{sum(a['converged'] for a in attempts)} accepted, Newton "
          f"{sum(a['newton'] for a in attempts)} / Krylov "
          f"{sum(a['krylov'] for a in attempts)} over all", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(attempts, f)


if __name__ == "__main__":
    main()
