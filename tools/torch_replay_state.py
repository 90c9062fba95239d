"""Save the port's replay state at a row of a reference grid, and trace the
next step's first attempt and continuation in dt.

    python3 tools/torch_replay_state.py [--bench bench2] [--row 109]
        [--out tests/data/bench2_replay_row109.npz] [--device cuda]
        [--state NPZ] [--save-root]

Replays ``results/<bench>_replay.csv`` with ``timeloop.run(time_grid=...)``
(the fixed Krylov forcing of a replay) for ``--row`` steps and writes the
accepted state there as f64 arrays ``v`` [F, ny+1, nx+1] and ``m`` [F, ny,
nx], with ``t`` (the row's time) and ``dt`` (the next grid step), to
``--out``. Then, from that state, it solves the next step at its full dt
and through the continuation in dt (``timeloop._CONTINUATION``: each root
seeds the next fraction, as the rescue ladder does) until a fraction
fails, printing per solve the Newton and Krylov counts, the convergence
flag and the Newton residual norms. bench2's row 109 (t = 80.87) is the
state before the t = 81.51 step that the port rescues by 2 x (dt/2) where
the JAX package's reference run took the continuation (ROADMAP Queue 3 item
3). ``--state`` starts from a saved state instead of replaying (its ``t``
and ``dt``); with ``--save-root`` the root of the deepest continuation
fraction that converges is added to that file as ``v_root``, ``m_root``
and ``root_frac`` (tests/test_torch_replay.py starts the 0.85 system
there).
"""

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pfhubbenchmarks_tpu_torch import timeloop  # noqa: E402
from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default="bench2")
    ap.add_argument("--row", type=int, default=109)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--state", default=None)
    ap.add_argument("--save-root", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_replay_state: no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    out = args.out or os.path.join(
        ROOT, "tests", "data", f"{args.bench}_replay_row{args.row}.npz")
    grid = np.loadtxt(os.path.join(ROOT, "results", f"{args.bench}_replay.csv"),
                      delimiter=",", skiprows=1)[:, 0]
    problem = get_benchmark(args.bench)
    problem = dataclasses.replace(problem, solver=dataclasses.replace(
        problem.solver, krylov_forcing="fixed"))
    runner = timeloop.Runner(problem, dev)
    if args.state:
        saved = dict(np.load(args.state))
        w0 = tuple(torch.tensor(saved[k], device=dev) for k in ("v", "m"))
        t, dt = float(saved["t"]), float(saved["dt"])
    else:
        t0 = time.perf_counter()
        res = timeloop.run(problem, device=dev, time_grid=grid,
                           max_steps=args.row, replay_partial=True,
                           verbose=False, _runner=runner)
        t = float(res.rows[-1, 0])
        if len(res.rows) != args.row or not np.isclose(t, grid[args.row - 1]):
            raise RuntimeError(f"the replay stopped at row {len(res.rows)}, "
                               f"t={t}")
        w0 = res.state
        dt = float(grid[args.row]) - t
        v, m = (x.detach().double().cpu().numpy() for x in w0)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(out, v=v, m=m, t=t, dt=dt)
        print(f"{args.bench}: replay to row {args.row} (t={t:.6g}) in "
              f"{time.perf_counter() - t0:.1f} s; state {v.shape} + "
              f"{m.shape} saved to {os.path.relpath(out, ROOT)}; next dt "
              f"{dt:.6g}", flush=True)

    def solve(tag, guess, d):
        r, _ = runner.step(guess, w0, d)
        hist = [float(h) for h in r.norm_hist if np.isfinite(h)]
        print(f"{tag} (dt={d:.6g}): newton {r.iters} krylov {r.krylov_iters} "
              f"converged {r.converged} |F| {['%.6e' % h for h in hist]}",
              flush=True)
        return r

    solve("full dt", w0, dt)
    g, g_frac = w0, 0.0
    for frac in timeloop._CONTINUATION:
        r = solve(f"continuation {frac:g}", g, frac * dt)
        if not r.converged:
            break
        g, g_frac = r.x, frac
    if args.save_root and args.state and g_frac:
        root = {f"{k}_root": x.detach().double().cpu().numpy()
                for k, x in zip(("v", "m"), g)}
        np.savez_compressed(args.state, **{**saved, **root,
                                           "root_frac": g_frac})
        print(f"the root of the {g_frac:g} dt continuation system added to "
              f"{args.state}", flush=True)


if __name__ == "__main__":
    main()
