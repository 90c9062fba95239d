"""Benchmark registry + shared CLI runner.

Run a ported benchmark as::

    python -m pfhubbenchmarks_tpu_torch.benchmarks.bench1 \
        [--device cuda|cpu] [--end-time T] [--max-steps N] [--nx N --ny N]
        [--replay CSV] [--out CSV]

(``bench2``, ``bench3``, ``bench6``, ``bench1_3d``, ``bench6_3d`` and the
linear validation problems ``poisson``, ``poisson3d`` and ``elast`` alike,
the 3D ones with ``--nz N`` too; ``bench2_eta1`` and ``bench2_eta2`` are BM2
with 1 and 2 order parameters, the reference's reduced variants).
``bench1_periodic`` is not yet ported. ``--replay CSV``
steps on the time grid of a CSV's column 0 (``timeloop.run(time_grid=...)``,
with ``replay_partial``: a step no rescue rung solves ends the run with its
rows), and writes the rows in the same schema.

``--device`` defaults to ``cuda``: the run is on the card unless the caller
asks for the CPU, and without a card it exits with an error. The JAX CLI's
other flags are accepted and raise "not yet ported".
"""

from __future__ import annotations

import argparse
import importlib
import time

_BENCHMARKS = {
    "bench1": "pfhubbenchmarks_tpu_torch.benchmarks.bench1",
    "bench1_3d": "pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d",
    "bench2": "pfhubbenchmarks_tpu_torch.benchmarks.bench2",
    "bench3": "pfhubbenchmarks_tpu_torch.benchmarks.bench3",
    "bench6": "pfhubbenchmarks_tpu_torch.benchmarks.bench6",
    "bench6_3d": "pfhubbenchmarks_tpu_torch.benchmarks.bench6_3d",
    "elast": "pfhubbenchmarks_tpu_torch.benchmarks.elast",
    "poisson": "pfhubbenchmarks_tpu_torch.benchmarks.poisson",
    "poisson3d": "pfhubbenchmarks_tpu_torch.benchmarks.poisson3d",
}

# JAX CLI flags the PyTorch slice does not implement yet (name -> takes a value)
_NOT_PORTED = {"--f32": False, "--mesh": True,
               "--no-damped-rescue": False, "--fused": False,
               "--checkpoint": True, "--resume": False, "--save-fields": True,
               "--fields-dir": True, "--stats-log": True, "--trace": True}


def get_benchmark(name: str, **kwargs):
    # reduced BM2 variants (dolfin/bench2_eta1.py / bench2_eta2.py)
    if name in ("bench2_eta1", "bench2_eta2"):
        kwargs.setdefault("num_eta", int(name[-1]))
        name = "bench2"
    if name not in _BENCHMARKS:
        raise ValueError(f"benchmark {name!r} is not yet ported; have "
                         f"{sorted(_BENCHMARKS)}")
    return importlib.import_module(_BENCHMARKS[name]).make(**kwargs)


def main(name: str, argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=f"PFHub {name} (PyTorch/CUDA)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--end-time", type=float, default=None)
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--out", type=str, default=f"results/{name}_torch_out.csv")
    ap.add_argument("--nx", type=int, default=None)
    ap.add_argument("--ny", type=int, default=None)
    ap.add_argument("--nz", type=int, default=None, help="3D benchmarks only")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--replay", type=str, default=None, metavar="CSV",
                    help="replay the time grid of a reference CSV (column 0) "
                         "instead of running the adaptive controller")
    for flag, takes_value in _NOT_PORTED.items():
        if takes_value:
            ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
        else:
            ap.add_argument(flag, action="store_const", const=True,
                            default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in _NOT_PORTED:
        if getattr(args, flag.lstrip("-").replace("-", "_")) is not None:
            raise SystemExit(f"{flag} is not yet ported to the PyTorch package")

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    kwargs = {}
    if args.nx:
        kwargs["nx"] = args.nx
    if args.ny:
        kwargs["ny"] = args.ny
    if args.nz:
        kwargs["nz"] = args.nz
    problem = get_benchmark(name, **kwargs)

    from pfhubbenchmarks_tpu_torch import timeloop
    from pfhubbenchmarks_tpu_torch.io.csvout import write_csv

    time_grid = None
    if args.replay:
        import numpy as np

        time_grid = np.loadtxt(args.replay, delimiter=",", skiprows=1)[:, 0]
    t0 = time.time()
    result = timeloop.run(problem, device=device, end_time=args.end_time,
                          max_steps=args.max_steps, verbose=not args.quiet,
                          time_grid=time_grid,
                          replay_partial=time_grid is not None)
    wall = time.time() - t0
    write_csv(args.out, result.rows, result.columns)
    n = len(result.rows)
    print(f"{name}: {n} steps to t={result.rows[-1, 0]:.6g} in {wall:.2f}s "
          f"({wall / max(n, 1):.3f}s/step) -> {args.out}")
