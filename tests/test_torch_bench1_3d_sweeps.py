"""The port's 3D sweeps and cycle against the JAX package, on seeded numpy
inputs:

- the 3D sweep loop of B, I and C (ops/lmr.py, 1-leaf states) against TPU
  kernels 15 (``make_pallas_lmr_sweep_loop3d``) and 17
  (``make_tiled_lmr_sweep3d``, ``block_rows`` 4) in interpret mode, at 8^3
  and keast2, with the port's block-Jacobi planes (from the hand-written
  tangent) held against the JAX package's first;
- one K-cycle apply at 20^3 (levels 20/10/5 at keast2, K-cycle 3 on 10^3,
  the dense 5^3 inverse) against ``make_gmg3d`` on the XLA path.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5 x max|ref|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1_3d import make as make_jax
from pfhubbenchmarks_tpu.ops import pallas3d
from pfhubbenchmarks_tpu.solve.gmg3d import make_gmg3d as jax_gmg3d
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi3d as jax_bj3d
from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.ops.lmr import make_lmr_sweep_loop
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

F = 2


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4,
                               atol=2e-5 * max(float(np.abs(ref).max()), 1.0))


def _inputs(n, seed, rule="keast2"):
    """(jax problem, port problem, jax grid, port grid, w, v, b): the IC plus
    seeded noise as the f32 state, and two random directions."""
    pj, pt = make_jax(nx=n, ny=n, nz=n), make_torch(nx=n, ny=n, nz=n)
    (w0,) = pt.grid.interpolate(pt.ic_fns)
    rng = np.random.default_rng(seed)
    w = (w0 + 0.05 * rng.standard_normal(w0.shape)).astype(np.float32)
    v, b = (rng.standard_normal(w0.shape).astype(np.float32) for _ in range(2))
    return (pj, pt, dataclasses.replace(pj.grid, rule_name=rule),
            dataclasses.replace(pt.grid, rule_name=rule), w, v, b)


def _sweep_pair(n_sweeps, seed):
    """The port's sweep loop on (0, v) and the inputs of the TPU sweeps."""
    pj, pt, gj, gt, w, v, _ = _inputs(8, seed)
    wj, wt = (jnp.asarray(w),), (torch.tensor(w),)
    pinv_j = jax_bj3d(gj, pj.terms, F, dtype=jnp.float32)(wj, wj, 0.4).pinv_planes
    pinv_t = make_block_jacobi3d(gt, pt.terms_tangent, F, device="cpu")(
        wt, wt, 0.4).pinv_planes
    _close(pinv_t[0], pinv_j)
    sweep = make_lmr_sweep_loop(pt.kernel_jvp(gt, "cpu"), n_sweeps)
    x, r = sweep((torch.zeros_like(wt[0]),), (torch.tensor(v),), wt, wt, 0.4,
                 *pinv_t)
    return pj, gj, wj, v, pinv_j, x, r


def test_sweep_loop_matches_whole_array_pallas_sweeps():
    pj, gj, wj, v, pinv_j, x, r = _sweep_pair(2, 13)
    sweep = pallas3d.make_pallas_lmr_sweep_loop3d(
        gj, pj.terms, F, dtype=jnp.float32, n_sweeps=2, interpret=True)
    xj, rj = sweep((jnp.zeros_like(wj[0]),), (jnp.asarray(v),), wj, wj, 0.4,
                   pinv_j)
    _close(x[0], xj[0])
    _close(r[0], rj[0])


def test_sweep_loop_matches_tiled_pallas_sweeps():
    pj, gj, wj, v, pinv_j, x, r = _sweep_pair(2, 14)
    prep, sweep = pallas3d.make_tiled_lmr_sweep3d(
        gj, pj.terms, F, dtype=jnp.float32, block_rows=4, interpret=True)
    xj, rj = sweep((jnp.zeros_like(wj[0]),), (jnp.asarray(v),), 2,
                   prep(wj, wj, pinv_j), 0.4)
    _close(x[0], xj[0])
    _close(r[0], rj[0])


def test_kcycle_apply_matches_jax_xla_cycle():
    pj, pt, _, _, w, v, _ = _inputs(20, 15, "ffc3")
    s = pj.solver
    build_t = pt.precond_builder("cpu")
    assert [g.nx for g in build_t.grids] == [20, 10, 5] and build_t.dense_coarse
    assert all(g.rule_name == "keast2" for g in build_t.grids)
    build_j = jax_gmg3d(pj.grid, pj.terms, F, dtype=jnp.float32,
                        precond_rule=s.precond_rule, kcycle=s.gmg_kcycle,
                        nu_pre=s.gmg_nu_pre, nu_post=s.gmg_nu_post)
    wt = (torch.tensor(w),)
    # jitted: the eager cycle dispatches (and compiles) op by op, ~6x slower
    (ref,) = jax.jit(lambda w_, v_: build_j((w_,), (w_,), 0.4)((v_,)))(
        jnp.asarray(w), jnp.asarray(v))
    (got,) = build_t(wt, wt, 0.4)((torch.tensor(v),))
    _close(got, ref)
