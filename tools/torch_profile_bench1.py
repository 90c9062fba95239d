"""Profile a main path of the PyTorch port on a CUDA device.

    python tools/torch_profile_bench1.py
        [--bench bench1|bench2|bench3|bench6|bench1_3d] [--end-time T]
        [--out-dir DIR]

Runs the benchmark at its published size (100x100; bench3 350x350,
bench1_3d 50^3) through ``timeloop.Runner`` (bench1 to t = 11.1, bench2 to
t = 6.63, bench3 to t = 12.15, its first 14 rows, bench1_3d to t = 12.7, its
first 10 rows, bench6 to its end time 3.0 by default) after
a short warm-up, once unprofiled (wall time, counts), then once more under
``torch.profiler`` with the CUDA activity only (the device-side events;
host-side op events would number in the millions on bench2, whose
block-Jacobi build runs ``torch.func``, and their tables take longer to
build than the run), and prints: the card (nvidia-smi name, power limit),
wall time, device busy time (the sum of kernel times on the device), the
idle share, and the kernels ranked by device time (the top 40 and every
kernel of csrc/). The chrome trace goes to ``--out-dir`` when given.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfhubbenchmarks_tpu_torch import timeloop  # noqa: E402
from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark  # noqa: E402
from pfhubbenchmarks_tpu_torch.ops import _lib  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", choices=("bench1", "bench2", "bench3", "bench6",
                                        "bench1_3d"), default="bench1")
    ap.add_argument("--end-time", type=float, default=None)
    ap.add_argument("--out-dir", type=str, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    end_time = args.end_time or {"bench1": 11.1, "bench2": 6.63,
                                 "bench3": 12.15, "bench6": None,
                                 "bench1_3d": 12.7}[args.bench]
    runner = timeloop.Runner(get_benchmark(args.bench), dev)
    _lib.library()
    runner.run(max_steps=2, verbose=False)   # warm-up: lazy CUDA/functorch init

    for label in ("plain run", "profiled run"):
        _lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if label == "plain run":
            res = runner.run(end_time=end_time, verbose=False)
            torch.cuda.synchronize()
            prof = None
        else:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                res = runner.run(end_time=end_time, verbose=False)
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = res.stats
        print(f"{label}: rows={len(res.rows)} t={res.rows[-1, 0]:.6g} "
              f"wall_s={wall:.3f} newton={sum(s.newton_iters for s in st)} "
              f"krylov={sum(s.krylov_iters for s in st)} "
              f"krylov_all={sum(s.krylov_iters_all for s in st)} "
              f"launches={dict(_lib.LAUNCHES)} chain_calls={dict(_lib.CALLS)}")
    # device-side events only (kernels, memcpy, memset)
    events = prof.key_averages()
    rows = [(e.key, e.count, e.self_device_time_total) for e in events
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    busy_us = sum(r[2] for r in rows)
    print(f"device busy {busy_us / 1e6:.3f} s of wall {wall:.3f} s: idle "
          f"share {1.0 - busy_us / 1e6 / wall:.3f}")
    ranked = sorted(rows, key=lambda r: -r[2])
    # the top 40, and every kernel of the port's own (csrc/) below them
    for rank, (key, count, us) in enumerate(ranked):
        if rank < 40 or "pfh::" in key or "(anonymous namespace)::" in key:
            print(f"  {us / 1e3:10.2f} ms  {count:8d}x  "
                  f"{us / max(count, 1):8.2f} us/call  {key[:120]}")
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out_dir,
                                              f"{args.bench}_trace.json"))


if __name__ == "__main__":
    main()
