"""The port's LMR sweep loop and field-split V-cycle for bench2 against the
JAX package, on seeded numpy inputs (split operator, dunavant1 rule, the
groups (c, mu), eta1, .., eta4):

- grouped B and C in the sweep loop (``ops/lmr.make_lmr_sweep_loop``)
  against ``make_pallas_lmr_sweep_loop`` and ``make_pallas_lmr_sweep``
  (TPU kernels 3 and 4; interpret, 16^2, 2 sweeps) and
  ``make_tiled_lmr_sweep`` (TPU kernel 11; 12^2, ``block_rows`` 6);
- the field-split V-cycle (``make_gmg`` with groups, the chains and the
  coarsest sweep loop) against the XLA ``make_gmg(field_groups=...,
  field_split_alphas=True)``, with A z the coupled true-rule J.v;
- bench2's own build: hierarchy 100/50/25 at dunavant1, no dense coarse.

Tolerances rtol 2e-4 / atol 2e-5 (tests/test_pallas_vcycle.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.ops.pallas_residual import (make_pallas_lmr_sweep,
                                                     make_pallas_lmr_sweep_loop)
from pfhubbenchmarks_tpu.ops.pallas_tiled import make_tiled_lmr_sweep
from pfhubbenchmarks_tpu.solve.gmg import make_gmg as jax_gmg
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import make as make_torch
from pfhubbenchmarks_tpu_torch.interop import state_to_numpy
from pfhubbenchmarks_tpu_torch.ops.lmr import make_lmr_sweep_loop
from pfhubbenchmarks_tpu_torch.solve.gmg import make_gmg
from tests.test_torch_bench2 import F, GROUPS, _close, _j, _states, _t


def _sweep_inputs(n, seed):
    """Split operator on the dunavant1 grid: JAX and port grids, the state,
    the JAX package's block-Jacobi planes, a random residual."""
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    gj = dataclasses.replace(pj.grid, rule_name="dunavant1")
    gt = dataclasses.replace(pt.grid, rule_name="dunavant1")
    w, _, _ = _states(n, seed)
    dt = 0.05
    pinv = jax.jit(lambda a: jax_bj(gj, pj.terms_precond, F, dtype=jnp.float32)(
        a, a, dt).pinv_planes)(_j(w))
    pinv = tuple(np.asarray(a) for a in pinv)
    rng = np.random.default_rng(seed + 1)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    x = tuple(np.zeros_like(a) for a in w)
    return pj, pt, gj, gt, w, pinv, r, x, dt


def _port_sweep(pt, gt, n_sweeps, w, pinv, r, x, dt):
    sweep = make_lmr_sweep_loop(pt.kernel_jvp(gt, "cpu", split=True),
                                n_sweeps, GROUPS)
    xt, rt = _t(x), _t(r)
    out = sweep(xt, rt, _t(w), _t(w), dt, *_t(pinv))
    assert out[0] is xt and out[1] is rt   # updated in place
    return state_to_numpy(out[0]) + state_to_numpy(out[1])


@pytest.mark.parametrize("maker", [make_pallas_lmr_sweep_loop,
                                   make_pallas_lmr_sweep])
def test_sweep_loop_matches_pallas_sweeps(maker):
    n, n_sweeps = 16, 2
    pj, pt, gj, gt, w, pinv, r, x, dt = _sweep_inputs(n, seed=4)
    sweep_j = maker(gj, pj.terms_precond, F, n_sweeps=n_sweeps,
                    field_groups=GROUPS, alpha_groups=GROUPS)
    (xj, rj) = sweep_j(_j(x), _j(r), _j(w), _j(w), dt, *_j(pinv),
                       interpret=True)
    _close(_port_sweep(pt, gt, n_sweeps, w, pinv, r, x, dt), xj + rj)


def test_sweep_loop_matches_tiled_sweep():
    """Row 11's arithmetic (per-block partial dots, alpha outside the
    kernel) is kernel C's two stages: the same sweeps at 12^2."""
    n, n_sweeps = 12, 1
    pj, pt, gj, gt, w, pinv, r, x, dt = _sweep_inputs(n, seed=6)
    prepare, sweep_j = make_tiled_lmr_sweep(
        gj, pj.terms_precond, F, dtype=jnp.float32, block_rows=6,
        field_groups=GROUPS, alpha_groups=GROUPS, interpret=True)
    xj, rj = sweep_j(_j(x), _j(r), n_sweeps, prepare(_j(w), _j(w), _j(pinv)),
                     jnp.asarray(dt, jnp.float32))
    _close(_port_sweep(pt, gt, n_sweeps, w, pinv, r, x, dt), xj + rj)


def test_field_split_gmg_matches_xla_gmg():
    n, dt = 16, 0.05
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, _, _ = _states(n, seed=7)
    rng = np.random.default_rng(8)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    kw = dict(precond_rule="dunavant1", min_cells=4, dense_coarse_max_dofs=0,
              nu_pre=2, nu_post=2, nu_fine_pre=1, coarse_sweeps=8,
              field_groups=GROUPS)
    jbuild = jax_gmg(pj.grid, pj.terms_precond, F, dtype=jnp.float32,
                     use_pallas=False, matvec_terms=pj.terms,
                     field_split_alphas=True, **kw)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, dt)(r_))(_j(w), _j(r))
    res32 = jax_residual(pj.grid, pj.terms, F, dtype=jnp.float32)
    _, azj = jax.jvp(lambda u: res32(u, _j(w), dt), (_j(w),), (zj,))

    tbuild = make_gmg(
        pt.grid, pt.terms_precond, F, device="cpu",
        jvp_for=lambda g, split: pt.kernel_jvp(g, "cpu", split=split), **kw)
    assert [g.nx for g in tbuild.grids] == [16, 8, 4] and not tbuild.dense_coarse
    zt, azt = tbuild(_t(w), _t(w), dt).minv_matvec(_t(r))
    _close(state_to_numpy(zt) + state_to_numpy(azt), tuple(zj) + tuple(azj))


def test_bench2_default_build():
    """bench2's own settings: field split on, hierarchy 100/50/25 at the
    dunavant1 rule, no dense coarse (7806 dofs > 1500)."""
    pt = make_torch()
    s = pt.solver
    assert (s.field_split, s.field_split_alphas, s.precond_rule,
            s.gmg_coarse_sweeps, s.gmres_restart) == (True, True, "dunavant1", 8, 16)
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [100, 50, 25]
    assert {g.rule_name for g in build.grids} == {"dunavant1"}
    assert not build.dense_coarse
