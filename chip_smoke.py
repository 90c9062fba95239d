"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its results; any failure raises (non-zero exit):

1. the card: CUDA must be available; prints nvidia-smi's name and power
   limit; TF32 must be off.
2. builds the four CUDA kernels from ``pfhubbenchmarks_tpu_torch/csrc``.
3. holds each kernel against its plain PyTorch version on the card, on
   seeded inputs at bench1's shapes (J.v at 100^2/50^2/25^2 for both
   quadrature rules, block-Jacobi and LMR at every level, transfers
   100<->50 and 50<->25), with CUDA-event times of both.
4. runs the port's bench1 at full size (100x100) through ``Runner``/``run``
   to t = 11.1 and holds the 10 rows against the committed
   ``results/bench1_out.csv`` (time column rtol 1e-9, TFE rel 1e-6, solute
   rel 1e-9); every kernel must have launched in that run.
5. prints the per-kernel JSON line, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
END_TIME = 11.1          # rows 1-10 of results/bench1_out.csv
N_ROWS = 10
TOL_F32 = dict(rtol=2e-4, atol_scale=2e-5)   # tests/test_pallas_vcycle.py
TOL_TRANSFER = dict(rtol=1e-6, atol_scale=1e-6)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median per-call time of ``fn`` over ``reps`` CUDA-event windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class Kernel:
    """Per-kernel aggregate of the phase-3 comparisons."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = None

    def check(self, label, got, ref, tol, timing=None):
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.abs().max()) for r in ref)
        ok = all(torch.allclose(g, r, rtol=tol["rtol"],
                                atol=tol["atol_scale"] * max(scale, 1.0))
                 for g, r in zip(got, ref))
        self.max_abs_err = max(self.max_abs_err, err)
        line = (f"check {self.name} {label}: max_abs_err={err:.3e} "
                f"max|ref|={scale:.3e} rel_err={err / max(scale, 1e-30):.3e} "
                f"rtol={tol['rtol']:g} "
                f"atol={tol['atol_scale']:g}*max(1,max|ref|)")
        if timing is not None:
            k_ms, p_ms = timing
            line += f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f}"
            if self.ms is None:      # the first timed case is the main shape
                self.ms, self.plain_ms = k_ms, p_ms
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            raise AssertionError(f"{self.name} {label} disagrees with its "
                                 f"plain version (max_abs_err {err:.3e})")

    def record(self, launches):
        return dict(name=self.name, route="cuda", source=self.source,
                    replaces=self.replaces, launches=launches,
                    max_abs_err=self.max_abs_err, ms=self.ms,
                    plain_ms=self.plain_ms)


def main() -> None:
    # ---- phase 1: the card --------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from pfhubbenchmarks_tpu_torch import config, timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import (
        Bench1Params, kernel_constants, make)
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops.ch_jvp import make_ch_jvp
    from pfhubbenchmarks_tpu_torch.solve.gmg import build_hierarchy
    from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"phase 1: {smi}", flush=True)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    if not config.tf32_disabled():
        raise AssertionError("TF32 is on")
    print("phase 1: TF32 off", flush=True)

    # ---- phase 2: build -------------------------------------------------
    lib = _lib.library()
    print(f"phase 2: built {lib.path.name} in {lib.build_seconds:.2f} s",
          flush=True)
    for ln in lib.build_log.splitlines():
        if "Used" in ln or "spill" in ln:
            print(f"phase 2: ptxas {ln.strip()}", flush=True)

    # ---- phase 3: kernels vs plain versions ----------------------------
    replaces_vc = "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:200"
    K = {
        "ch_jvp": Kernel("ch_jvp", "pfhubbenchmarks_tpu_torch/csrc/ch_jvp.cu",
                         "pfhubbenchmarks_tpu/ops/pallas_residual.py:198"),
        "block_jacobi_apply": Kernel(
            "block_jacobi_apply",
            "pfhubbenchmarks_tpu_torch/csrc/block_jacobi.cu", replaces_vc),
        "lmr_step": Kernel("lmr_step", "pfhubbenchmarks_tpu_torch/csrc/lmr.cu",
                           replaces_vc),
        "transfer_dyadic": Kernel(
            "transfer_dyadic", "pfhubbenchmarks_tpu_torch/csrc/transfer.cu",
            replaces_vc),
    }
    problem = make()
    params = Bench1Params()
    rng = np.random.default_rng(20261016)
    dt = 0.5
    grids = build_hierarchy(problem.grid, min_cells=problem.solver.gmg_min_cells)
    assert [g.nx for g in grids] == [100, 50, 25], [g.nx for g in grids]

    def noise_pair(g, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((2,) + s),
                                  dtype=torch.float32, device=dev)
                     for s in (g.vshape, g.mshape))

    def state_on(g):
        v, m = g.interpolate(problem.ic_fns)
        return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                     + n for a, n in zip((v, m), noise_pair(g, 0.01)))

    t3 = time.perf_counter()
    for rule in ("ffc3", "dunavant2"):
        for g0 in grids:
            g = dataclasses.replace(g0, rule_name=rule)
            jv = make_ch_jvp(g, problem.terms, kernel_constants(params),
                             device=dev)
            w, v, b = state_on(g), noise_pair(g), noise_pair(g)
            got = jv.kernel(w, w, dt, v)
            ref = jv.plain(w, w, dt, v)
            timing = (cuda_ms(lambda: jv.kernel(w, w, dt, v)),
                      cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10))
            K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx}", got, ref, TOL_F32, timing)
            if g.nx == 100:
                K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx} b-Jv",
                                  jv.kernel(w, w, dt, v, b=b),
                                  jv.plain(w, w, dt, v, b=b), TOL_F32)

    for g0 in grids:
        g = dataclasses.replace(g0, rule_name="dunavant2")
        w = state_on(g)
        planes = make_block_jacobi(g, problem.terms, 2, device=dev)(
            w, w, dt).pinv_planes
        r = noise_pair(g)
        timing = (cuda_ms(lambda: lmr.block_jacobi_apply_kernel(planes, r)),
                  cuda_ms(lambda: lmr.block_jacobi_apply_plain(planes, r)))
        K["block_jacobi_apply"].check(
            f"{g.ny}x{g.nx}", lmr.block_jacobi_apply_kernel(planes, r),
            lmr.block_jacobi_apply_plain(planes, r), TOL_F32, timing)

        x, r, z, az = (noise_pair(g) for _ in range(4))
        xk, rk = [tuple(t.clone() for t in p) for p in (x, r)]
        xp, rp = [tuple(t.clone() for t in p) for p in (x, r)]
        lmr.lmr_step_kernel(xk, rk, z, az)
        lmr.lmr_step_plain(xp, rp, z, az)
        xs, rs = [tuple(t.clone() for t in p) for p in (x, r)]  # timing scratch
        timing = (cuda_ms(lambda: lmr.lmr_step_kernel(xs, rs, z, az)),
                  cuda_ms(lambda: lmr.lmr_step_plain(xs, rs, z, az)))
        K["lmr_step"].check(f"{g.ny}x{g.nx}", xk + rk, xp + rp, TOL_F32, timing)

    for fine, coarse in zip(grids[:-1], grids[1:]):
        lab = f"{fine.nx}<->{coarse.nx}"
        xc, rf = noise_pair(coarse), noise_pair(fine)
        timing = (cuda_ms(lambda: kt.prolong_kernel(xc, coarse, fine)),
                  cuda_ms(lambda: kt.prolong_plain(xc, coarse, fine)))
        K["transfer_dyadic"].check(f"prolong {lab}",
                                   kt.prolong_kernel(xc, coarse, fine),
                                   kt.prolong_plain(xc, coarse, fine),
                                   TOL_TRANSFER, timing)
        acc = tuple(t.clone() for t in rf)
        kt.prolong_kernel(xc, coarse, fine, out=acc)
        K["transfer_dyadic"].check(
            f"prolong+= {lab}", acc,
            tuple(a + p for a, p in zip(rf, kt.prolong_plain(xc, coarse, fine))),
            TOL_TRANSFER)
        timing = (cuda_ms(lambda: kt.restrict_kernel(rf, coarse, fine)),
                  cuda_ms(lambda: kt.restrict_plain(rf, coarse, fine)))
        K["transfer_dyadic"].check(f"restrict {lab}",
                                   kt.restrict_kernel(rf, coarse, fine),
                                   kt.restrict_plain(rf, coarse, fine),
                                   TOL_TRANSFER, timing)
        K["transfer_dyadic"].check(f"inject {lab}",
                                   kt.inject_kernel(rf, coarse, fine),
                                   kt.inject_plain(rf, coarse, fine),
                                   TOL_TRANSFER)
    torch.cuda.synchronize()
    print(f"phase 3: all kernels agree with their plain versions "
          f"({time.perf_counter() - t3:.1f} s)", flush=True)

    # ---- phase 4: bench1 main path at 100x100 ---------------------------
    ref_rows, cols = read_csv(os.path.join(HERE, "results", "bench1_out.csv"))
    ref_rows = ref_rows[:N_ROWS]
    runner = timeloop.Runner(problem, dev)
    _lib.reset_launches()
    t4 = time.perf_counter()
    result = runner.run(end_time=END_TIME, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t4
    launches = dict(_lib.LAUNCHES)
    rows = result.rows
    steps = len(result.stats)
    newton = sum(s.newton_iters for s in result.stats)
    krylov = sum(s.krylov_iters for s in result.stats)
    newton_all = sum(s.newton_iters_all for s in result.stats)
    krylov_all = sum(s.krylov_iters_all for s in result.stats)
    print(f"phase 4: bench1 100x100 to t={rows[-1, 0]:.6g}: steps={steps} "
          f"newton={newton} krylov={krylov} newton_all={newton_all} "
          f"krylov_all={krylov_all} wall_s={wall:.3f} launches={launches}",
          flush=True)
    if list(result.columns) != cols:
        raise AssertionError(f"columns {result.columns} != {cols}")
    if rows.shape != ref_rows.shape or not np.isfinite(rows).all():
        raise AssertionError(f"rows {rows.shape} vs reference {ref_rows.shape}")
    np.testing.assert_allclose(rows[:, 0], ref_rows[:, 0], rtol=1e-9, atol=0)
    tfe_rel = float(np.max(np.abs(rows[:, 1] - ref_rows[:, 1])
                           / np.abs(ref_rows[:, 1])))
    sol_rel = float(np.max(np.abs(rows[:, 2] - ref_rows[:, 2])
                           / np.abs(ref_rows[:, 2])))
    print(f"phase 4: vs results/bench1_out.csv rows 1-{N_ROWS}: time column "
          f"equal, tfe_rel={tfe_rel:.3e} (<=1e-6), solute_rel={sol_rel:.3e} "
          f"(<=1e-9)", flush=True)
    if tfe_rel > 1e-6 or sol_rel > 1e-9:
        raise AssertionError("bench1 rows disagree with the reference CSV")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # ---- phase 5: summary ------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [K[k].record(launches[k]) for k in _lib.KERNELS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
