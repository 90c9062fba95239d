"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its results; any failure raises (non-zero exit):

1. the card: CUDA must be available; prints nvidia-smi's name and power
   limit; TF32 must be off.
2. builds the CUDA kernels from ``pfhubbenchmarks_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel).
3. holds each kernel against its plain PyTorch version on the card, on
   seeded inputs at bench1's shapes (J.v at 100^2/50^2/25^2 for both
   quadrature rules, block-Jacobi and LMR at every level, transfers
   100<->50 and 50<->25), with CUDA-event times of both.
4. bench1's main path: the port's bench1 at full size (100x100) through
   ``Runner.run`` to t = 11.1; the 10 rows against the committed
   ``results/bench1_out.csv`` (time column rtol 1e-9, TFE rel 1e-6, solute
   rel 1e-9); each kernel and chain of that path must have run in that run.
5. the same checks at bench6's shapes (F = 3, levels 100^2/50^2/25^2): the
   CH+Poisson J.v (kernel E) for both rules, J.v and b - J.v forms, with
   and without the Dirichlet mask; the masked transfers; the descend and
   ascend chains against their plain twins.
6. bench6's main path: the port's bench6 at full size (100x100) through
   ``Runner.run`` to t = 3.19; the 14 rows against the committed
   ``results/bench6_out.csv`` (time column rtol 1e-9, TFE rel 1e-6, solute
   rel 1e-9); each kernel and chain of that path must have launched.
7. prints the card line, the per-kernel JSON line, then
   ``{"ok": true, "device": ...}``.

In the kernel line, ``kernels`` lists the CUDA kernels: ``launches`` is the
sum of a kernel's launches over the two main-path runs (each counted from 0
just before its run; ``paths`` splits it), ``ms``/``plain_ms`` are the
CUDA-event times of its first timed case, ``bound_ms`` the least time the
card could take for that case: the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its f32 operations over
67 TFLOP/s (H100 SXM data sheet), with ``bound_by`` naming which.
``library_ms`` is one PyTorch call computing the same function where there
is one (block-Jacobi's einsum pair), else null. ``chains`` lists the two
V-cycle chains, launch sequences of those kernels that stand for TPU
kernels 7 and 8, with the same keys, except ``calls`` (chain calls on the
main paths) in place of ``launches`` and ``sequence_of`` in place of
``route``; their arithmetic is counted again under the kernels.
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
BENCH1_END, BENCH1_ROWS = 11.1, 10   # rows 1-10 of results/bench1_out.csv
BENCH6_ROWS = 14                      # results/bench6_out.csv, to t = 3.19
TOL_F32 = dict(rtol=2e-4, atol_scale=2e-5)   # tests/test_pallas_vcycle.py
TOL_EXACT = dict(rtol=0.0, atol_scale=0.0)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations of one pointwise tangent as written, negations folded into
# the contraction: ch_jvp.cu's CH (F = 2), chp_jvp.cu's CH+Poisson (F = 3)
TANGENT_OPS = {2: 16, 3: 20}


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


# ---- work of one call, from the shapes (for bound_ms) ----------------------

def nodes(g) -> int:
    return (g.ny + 1) * (g.nx + 1) + g.ny * g.nx


def jvp_work(g, F, masked=False, with_b=False):
    """(bytes, flops) of one J.v: c plane + F tangent planes (+ b, mask) in,
    F planes out. Per triangle (4 per cell, 3 nodes each): the F gradients
    (2 * (3 mul + 2 add) per field), and per quadrature point the
    interpolation of c and the F tangents (3 mul + 2 add each), the tangent
    (TANGENT_OPS) and the test-function contraction (3 nodes x 3 terms x
    mul + add per field)."""
    N, nq = nodes(g), g.tab().nq
    byts = 4 * (N + 2 * F * N + (F * N if with_b else 0)
                + (F * (g.ny + 1) * (g.nx + 1) if masked else 0))
    flops = g.ny * g.nx * 4 * (10 * F + nq * (5 * (1 + F) + TANGENT_OPS[F]
                                              + 18 * F))
    return byts, flops


def bj_work(g, F):
    N = nodes(g)
    return 4 * (F * F * N + 2 * F * N), 2 * F * F * N


def lmr_work(g, F):
    N = nodes(g)   # x, r, z, Az in; x, r out; two dots and two axpys
    return 4 * 6 * F * N, 8 * F * N


def transfer_work(coarse, fine, F, op, masked=False, accumulate=False):
    nc, nf = nodes(coarse), nodes(fine)
    mask = F * ((fine if op == "prolong" else coarse).ny + 1) * (
        (fine if op == "prolong" else coarse).nx + 1) if masked else 0
    if op == "prolong":
        return 4 * (F * nc + F * nf * (2 if accumulate else 1) + mask), 2 * F * nf
    return 4 * (F * nf + F * nc + mask), 2 * F * nf


def chain_work(grids, F, nu, nu_fine, ascend: bool):
    """Inputs once (rhs, per-level c planes, block planes, masks, and for the
    ascent the iterates and coarse correction), outputs once; the flops of
    its sweeps, residuals and transfers."""
    K = len(grids) - 1
    byts = flops = 0
    for l in range(K):
        g, N = grids[l], nodes(grids[l])
        n = nu_fine if l == 0 else nu
        byts += 4 * (N + F * F * N + F * (g.ny + 1) * (g.nx + 1))
        byts += 4 * F * N * (2 if ascend else 1)   # rhs (+ iterate) in
        flops += n * (jvp_work(g, F)[1] + bj_work(g, F)[1] + lmr_work(g, F)[1])
        op = "prolong" if ascend else "restrict"
        flops += transfer_work(grids[l + 1], g, F, op)[1]
        if ascend:
            flops += jvp_work(g, F)[1]
        elif l + 1 < K:
            byts += 4 * F * nodes(grids[l + 1])   # restricted rhs out
    if ascend:
        byts += 4 * F * (nodes(grids[K]) + nodes(grids[0]))   # xc in, z out
    else:
        byts += 4 * F * (sum(nodes(g) for g in grids[:K]) + nodes(grids[K]))
    return byts, flops


def bound(work):
    byts, flops = work
    t_b, t_f = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


class Kernel:
    """Per-kernel aggregate of the comparisons against the plain twins."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.max_abs_err = 0.0
        self.ms = self.plain_ms = self.bound_ms = self.bound_by = None
        self.library_ms = None

    def check(self, label, got, ref, tol, timing=None, work=None,
              library_ms=None):
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
            b_ms, b_by = bound(work)
            line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                     f"bound_ms={b_ms:.6f} ({b_by})")
            if library_ms is not None:
                line += f" library_ms={library_ms:.4f}"
            if self.ms is None:      # the first timed case is the main shape
                self.ms, self.plain_ms = k_ms, p_ms
                self.bound_ms, self.bound_by = b_ms, b_by
                self.library_ms = library_ms
        print(line + (" ok" if ok else " FAIL"), flush=True)
        if not ok:
            raise AssertionError(f"{self.name} {label} disagrees with its "
                                 f"plain version (max_abs_err {err:.3e})")

    def record(self, paths: dict):
        launches = sum(p.get(self.name, 0) for p in paths.values())
        return dict(name=self.name, route="cuda", source=self.source,
                    replaces=self.replaces, launches=launches,
                    max_abs_err=self.max_abs_err, ms=self.ms,
                    plain_ms=self.plain_ms, bound_ms=self.bound_ms,
                    bound_by=self.bound_by, library_ms=self.library_ms,
                    paths={k: p.get(self.name, 0) for k, p in paths.items()})


class Chain(Kernel):
    """A launch sequence of the kernels that stands for one TPU kernel."""

    def __init__(self, name, replaces, sequence_of):
        super().__init__(name, "pfhubbenchmarks_tpu_torch/ops/vcycle_chain.py",
                         replaces)
        self.sequence_of = sequence_of

    def record(self, paths: dict):
        rec = super().record(paths)
        del rec["route"]
        rec["calls"] = rec.pop("launches")
        rec["sequence_of"] = list(self.sequence_of)
        return rec


def run_main_path(label, runner, end_time, ref_csv, n_rows, required):
    """Drive ``runner`` to ``end_time`` with the launch and chain-call counts
    set to 0 just before and read just after; hold its rows against
    ``ref_csv``."""
    from pfhubbenchmarks_tpu_torch.io.csvout import read_csv
    from pfhubbenchmarks_tpu_torch.ops import _lib

    ref_rows, cols = read_csv(os.path.join(HERE, "results", ref_csv))
    ref_rows = ref_rows[:n_rows]
    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    result = runner.run(end_time=end_time, verbose=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)
    calls = dict(_lib.CALLS)
    rows = result.rows
    st = result.stats
    print(f"{label}: {runner.problem.grid.ny}x{runner.problem.grid.nx} to "
          f"t={rows[-1, 0]:.6g}: steps={len(st)} "
          f"newton={sum(s.newton_iters for s in st)} "
          f"krylov={sum(s.krylov_iters for s in st)} "
          f"newton_all={sum(s.newton_iters_all for s in st)} "
          f"krylov_all={sum(s.krylov_iters_all for s in st)} "
          f"wall_s={wall:.3f} launches={launches} chain_calls={calls}",
          flush=True)
    print(f"{label}: krylov per step {[s.krylov_iters for s in st]}, "
          f"newton per step {[s.newton_iters for s in st]}", flush=True)
    if list(result.columns) != cols:
        raise AssertionError(f"columns {result.columns} != {cols}")
    if rows.shape != ref_rows.shape or not np.isfinite(rows).all():
        raise AssertionError(f"rows {rows.shape} vs reference {ref_rows.shape}")
    np.testing.assert_allclose(rows[:, 0], ref_rows[:, 0], rtol=1e-9, atol=0)
    tfe_rel = float(np.max(np.abs(rows[:, 1] - ref_rows[:, 1])
                           / np.abs(ref_rows[:, 1])))
    sol_rel = float(np.max(np.abs(rows[:, 2] - ref_rows[:, 2])
                           / np.abs(ref_rows[:, 2])))
    print(f"{label}: vs results/{ref_csv} rows 1-{n_rows}: time column "
          f"equal, tfe_rel={tfe_rel:.3e} (<=1e-6), solute_rel={sol_rel:.3e} "
          f"(<=1e-9)", flush=True)
    if tfe_rel > 1e-6 or sol_rel > 1e-9:
        raise AssertionError(f"{label}: rows disagree with results/{ref_csv}")
    counts = {**launches, **calls}
    missing = [k for k in required if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: did not run on the main path: {missing}")
    return counts


def main() -> None:
    # ---- phase 1: the card --------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    from pfhubbenchmarks_tpu_torch import config, timeloop
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench6
    from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
    from pfhubbenchmarks_tpu_torch.ops import transfer as kt
    from pfhubbenchmarks_tpu_torch.ops.ch_jvp import make_ch_jvp
    from pfhubbenchmarks_tpu_torch.ops.chp_jvp import make_chp_jvp
    from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                            make_descend_chain)
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

    # ---- phase 3: kernels vs plain versions at bench1's shapes ---------
    replaces_vc = "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:200"
    replaces_jv = "pfhubbenchmarks_tpu/ops/pallas_residual.py:198"
    csrc = "pfhubbenchmarks_tpu_torch/csrc/"
    K = {
        "ch_jvp": Kernel("ch_jvp", csrc + "ch_jvp.cu", replaces_jv),
        "chp_jvp": Kernel("chp_jvp", csrc + "chp_jvp.cu", replaces_jv),
        "block_jacobi_apply": Kernel("block_jacobi_apply",
                                     csrc + "block_jacobi.cu", replaces_vc),
        "lmr_step": Kernel("lmr_step", csrc + "lmr.cu", replaces_vc),
        "transfer_dyadic": Kernel("transfer_dyadic", csrc + "transfer.cu",
                                  replaces_vc),
    }
    seq = ("level J.v (ch_jvp or chp_jvp)", "block_jacobi_apply", "lmr_step",
           "transfer_dyadic")
    C = {
        "descend_chain": Chain("descend_chain",
                               "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:652",
                               seq),
        "ascend_chain": Chain("ascend_chain",
                              "pfhubbenchmarks_tpu/ops/pallas_vcycle.py:798",
                              seq),
    }
    assert set(K) == set(_lib.KERNELS) and set(C) == set(_lib.CHAINS)
    rng = np.random.default_rng(20261016)

    def noise_pair(g, F, scale=1.0):
        return tuple(torch.tensor(scale * rng.standard_normal((F,) + s),
                                  dtype=torch.float32, device=dev)
                     for s in (g.vshape, g.mshape))

    def state_on(problem, g):
        """The IC on ``g`` plus seeded noise, with its Dirichlet values."""
        F = problem.n_fields
        v, m = g.interpolate(problem.ic_fns)
        v, m = (torch.tensor(a, dtype=torch.float32, device=dev) + n
                for a, n in zip((v, m), noise_pair(g, F, 0.01)))
        for bc in problem.dirichlet_for(g):
            v = bc.apply_value(v)
        return v.contiguous(), m

    problem1 = bench1.make()
    dt = 0.5
    grids1 = build_hierarchy(problem1.grid,
                             min_cells=problem1.solver.gmg_min_cells)
    assert [g.nx for g in grids1] == [100, 50, 25], [g.nx for g in grids1]

    t3 = time.perf_counter()
    for rule in ("ffc3", "dunavant2"):
        for g0 in grids1:
            g = dataclasses.replace(g0, rule_name=rule)
            jv = make_ch_jvp(g, problem1.terms,
                             bench1.kernel_constants(bench1.Bench1Params()),
                             device=dev)
            w, v, b = state_on(problem1, g), noise_pair(g, 2), noise_pair(g, 2)
            timing = (cuda_ms(lambda: jv.kernel(w, w, dt, v)),
                      cuda_ms(lambda: jv.plain(w, w, dt, v), reps=10))
            K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx}", jv.kernel(w, w, dt, v),
                              jv.plain(w, w, dt, v), TOL_F32, timing,
                              jvp_work(g, 2))
            if g.nx == 100:
                K["ch_jvp"].check(f"{rule} {g.ny}x{g.nx} b-Jv",
                                  jv.kernel(w, w, dt, v, b=b),
                                  jv.plain(w, w, dt, v, b=b), TOL_F32)

    def check_bj_lmr(problem, grids, F, label):
        for g0 in grids:
            g = dataclasses.replace(g0, rule_name="dunavant2")
            w = state_on(problem, g)
            planes = make_block_jacobi(
                g, problem.terms, F, device=dev,
                dirichlet=problem.dirichlet_for(g))(w, w, dt).pinv_planes
            r = noise_pair(g, F)
            plain_ms = cuda_ms(lambda: lmr.block_jacobi_apply_plain(planes, r))
            timing = (cuda_ms(lambda: lmr.block_jacobi_apply_kernel(planes, r)),
                      plain_ms)
            K["block_jacobi_apply"].check(
                f"{label} {g.ny}x{g.nx}", lmr.block_jacobi_apply_kernel(planes, r),
                lmr.block_jacobi_apply_plain(planes, r), TOL_F32, timing,
                bj_work(g, F), library_ms=plain_ms)

            x, r, z, az = (noise_pair(g, F) for _ in range(4))
            xk, rk = [tuple(t.clone() for t in p) for p in (x, r)]
            xp, rp = [tuple(t.clone() for t in p) for p in (x, r)]
            lmr.lmr_step_kernel(xk, rk, z, az)
            lmr.lmr_step_plain(xp, rp, z, az)
            xs, rs = [tuple(t.clone() for t in p) for p in (x, r)]  # scratch
            timing = (cuda_ms(lambda: lmr.lmr_step_kernel(xs, rs, z, az)),
                      cuda_ms(lambda: lmr.lmr_step_plain(xs, rs, z, az)))
            K["lmr_step"].check(f"{label} {g.ny}x{g.nx}", xk + rk, xp + rp,
                                TOL_F32, timing, lmr_work(g, F))

    def check_transfers(problem, grids, F, label):
        kd = K["transfer_dyadic"]
        for fine, coarse in zip(grids[:-1], grids[1:]):
            lab = f"{label} {fine.nx}<->{coarse.nx}"
            mf, mc = (None if m is None else torch.as_tensor(m, device=dev)
                      for m in (bc_mask(g, problem.dirichlet_for(g), F)
                                for g in (fine, coarse)))
            xc, rf = noise_pair(coarse, F), noise_pair(fine, F)
            timing = (cuda_ms(lambda: kt.prolong_kernel(xc, coarse, fine, mask=mf)),
                      cuda_ms(lambda: kt.prolong_plain(xc, coarse, fine, mf)))
            kd.check(f"prolong {lab}", kt.prolong_kernel(xc, coarse, fine, mask=mf),
                     kt.prolong_plain(xc, coarse, fine, mf), TOL_EXACT, timing,
                     transfer_work(coarse, fine, F, "prolong", mf is not None))
            acc = tuple(t.clone() for t in rf)
            kt.prolong_kernel(xc, coarse, fine, out=acc, mask=mf)
            kd.check(f"prolong+= {lab}", acc, kt.prolong_accumulate_plain(
                xc, coarse, fine, tuple(t.clone() for t in rf), mf), TOL_EXACT)
            timing = (cuda_ms(lambda: kt.restrict_kernel(rf, coarse, fine, mc)),
                      cuda_ms(lambda: kt.restrict_plain(rf, coarse, fine, mc)))
            kd.check(f"restrict {lab}", kt.restrict_kernel(rf, coarse, fine, mc),
                     kt.restrict_plain(rf, coarse, fine, mc), TOL_EXACT, timing,
                     transfer_work(coarse, fine, F, "restrict", mc is not None))
            kd.check(f"inject {lab}", kt.inject_kernel(rf, coarse, fine),
                     kt.inject_plain(rf, coarse, fine), TOL_EXACT)

    check_bj_lmr(problem1, grids1, 2, "bench1")
    check_transfers(problem1, grids1, 2, "bench1")
    torch.cuda.synchronize()
    print(f"phase 3: bench1-shape kernels agree with their plain versions "
          f"({time.perf_counter() - t3:.1f} s)", flush=True)

    # ---- phase 4: bench1's main path at 100x100 -------------------------
    paths = {}
    paths["bench1"] = run_main_path(
        "phase 4: bench1", timeloop.Runner(problem1, dev), BENCH1_END,
        "bench1_out.csv", BENCH1_ROWS,
        ("ch_jvp", "block_jacobi_apply", "lmr_step", "transfer_dyadic",
         "descend_chain", "ascend_chain"))

    # ---- phase 5: kernels and chains at bench6's shapes -----------------
    problem6 = bench6.make()
    F6 = problem6.n_fields
    s6 = problem6.solver
    grids6 = [dataclasses.replace(g, rule_name=s6.precond_rule)
              for g in build_hierarchy(problem6.grid, min_cells=s6.gmg_min_cells)]
    assert [g.nx for g in grids6] == [100, 50, 25], [g.nx for g in grids6]
    dt6 = 0.32
    t5 = time.perf_counter()
    const6 = bench6.kernel_constants(bench6.Bench6Params())
    for rule in ("ffc3", "dunavant2"):
        for g0 in grids6:
            g = dataclasses.replace(g0, rule_name=rule)
            w, v, b = (state_on(problem6, g), noise_pair(g, F6),
                       noise_pair(g, F6))
            for bcs in (problem6.dirichlet_for(g), ()):
                jv = make_chp_jvp(g, problem6.terms, const6, device=dev,
                                  dirichlet=bcs)
                lab = f"{rule} {g.ny}x{g.nx} {'masked' if bcs else 'unmasked'}"
                timing = work = None
                if g.nx == 100 and bcs:
                    timing = (cuda_ms(lambda: jv.kernel(w, w, dt6, v)),
                              cuda_ms(lambda: jv.plain(w, w, dt6, v), reps=10))
                    work = jvp_work(g, F6, masked=True)
                K["chp_jvp"].check(f"{lab} Jv", jv.kernel(w, w, dt6, v),
                                   jv.plain(w, w, dt6, v), TOL_F32, timing, work)
                K["chp_jvp"].check(f"{lab} b-Jv", jv.kernel(w, w, dt6, v, b=b),
                                   jv.plain(w, w, dt6, v, b=b), TOL_F32)

    check_bj_lmr(problem6, grids6, F6, "bench6")
    check_transfers(problem6, grids6, F6, "bench6")

    # the chains, on the injected per-level states and their block planes
    masks6 = [None if m is None else torch.as_tensor(m, device=dev)
              for m in (bc_mask(g, problem6.dirichlet_for(g), F6) for g in grids6)]
    jvs6 = [problem6.kernel_jvp(g, dev, problem6.dirichlet_for(g)) for g in grids6]
    w_ls, pinvs = [], []
    wl = state_on(problem6, grids6[0])
    for l, g in enumerate(grids6[:-1]):
        w_ls.append(wl)
        pinvs.append(make_block_jacobi(
            g, problem6.terms, F6, device=dev,
            dirichlet=problem6.dirichlet_for(g))(wl, wl, dt6).pinv_planes)
        wl = kt.inject_plain(wl, grids6[l + 1], g)
    nus = dict(nu=s6.gmg_nu_pre, nu_fine=s6.gmg_nu_fine_pre or s6.gmg_nu_pre)
    descend = make_descend_chain(grids6, jvs6, masks=masks6, **nus)
    ascend = make_ascend_chain(grids6, jvs6, masks=masks6, nu=s6.gmg_nu_post,
                               nu_fine=s6.gmg_nu_fine_post or s6.gmg_nu_post)
    b0 = noise_pair(grids6[0], F6)
    xs_k, bs_k, bc_k = descend.kernel(b0, w_ls, w_ls, dt6, pinvs)
    xs_p, bs_p, bc_p = descend.plain(b0, w_ls, w_ls, dt6, pinvs)
    timing = (cuda_ms(lambda: descend.kernel(b0, w_ls, w_ls, dt6, pinvs), reps=10),
              cuda_ms(lambda: descend.plain(b0, w_ls, w_ls, dt6, pinvs), reps=3))
    work = chain_work(grids6, F6, nus["nu"], nus["nu_fine"], ascend=False)
    got = [t for p in xs_k + bs_k + [bc_k] for t in p]
    ref = [t for p in xs_p + bs_p + [bc_p] for t in p]
    C["descend_chain"].check("100/50/25", got, ref, TOL_F32, timing, work)
    xc = noise_pair(grids6[-1], F6)
    bs_in = [b0] + bs_p
    timing = (cuda_ms(lambda: ascend.kernel(bs_in, xs_p, xc, w_ls, w_ls, dt6,
                                            pinvs), reps=10),
              cuda_ms(lambda: ascend.plain(bs_in, xs_p, xc, w_ls, w_ls, dt6,
                                           pinvs), reps=3))
    work = chain_work(grids6, F6, s6.gmg_nu_post,
                      s6.gmg_nu_fine_post or s6.gmg_nu_post, ascend=True)
    C["ascend_chain"].check(
        "100/50/25", ascend.kernel(bs_in, xs_p, xc, w_ls, w_ls, dt6, pinvs),
        ascend.plain(bs_in, xs_p, xc, w_ls, w_ls, dt6, pinvs), TOL_F32, timing,
        work)
    torch.cuda.synchronize()
    print(f"phase 5: bench6-shape kernels and chains agree with their plain "
          f"versions ({time.perf_counter() - t5:.1f} s)", flush=True)

    # ---- phase 6: bench6's main path at 100x100 -------------------------
    runner6 = timeloop.Runner(problem6, dev)
    build = runner6.problem.precond_builder(dev)
    print(f"phase 6: hierarchy {[g.nx for g in build.grids]}, coarsest solve "
          f"{'dense' if build.dense_coarse else f'{s6.gmg_coarse_sweeps} LMR sweeps'}",
          flush=True)
    paths["bench6"] = run_main_path(
        "phase 6: bench6", runner6, None, "bench6_out.csv", BENCH6_ROWS,
        ("chp_jvp", "descend_chain", "ascend_chain", "block_jacobi_apply",
         "lmr_step", "transfer_dyadic"))

    # ---- phase 7: summary ------------------------------------------------
    print(smi, flush=True)
    print(json.dumps({"kernels": [K[k].record(paths) for k in _lib.KERNELS],
                      "chains": [C[k].record(paths) for k in _lib.CHAINS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
