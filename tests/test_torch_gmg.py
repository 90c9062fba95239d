"""The port's V-cycle (z, A z) against the JAX package:

- the fused whole-V-cycle Pallas kernel (interpret mode) at 16^2, two
  levels, with the per-level inputs of tests/test_pallas_vcycle.py's
  ``_ladder`` and bench1's cycle shape (dunavant2 hierarchy, ffc3 exported
  matvec, nu 3/3 with one fine pre-sweep, 8 coarse sweeps);
- the XLA V-cycle ``make_gmg(use_pallas=False, dense_coarse_max_dofs=0)``
  at 32^2 (L = 64, min_cells 8: levels 32/16/8), bench1's settings;
- the exact dense coarse solve against the XLA cycle's at 16^2.

rtol 2e-4 / atol 2e-5 as in tests/test_pallas_vcycle.py (f32, different
summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.ops.pallas_vcycle import make_fused_vcycle
from pfhubbenchmarks_tpu.solve.gmg import build_hierarchy
from pfhubbenchmarks_tpu.solve.gmg import make_gmg as jax_gmg
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi
from pfhubbenchmarks_tpu.solve.transfer import inject_any
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import make as make_torch
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.solve.gmg import make_gmg

F32 = dict(rtol=2e-4, atol=2e-5)
BENCH1_NU = dict(nu_pre=3, nu_post=3, nu_fine_pre=1, coarse_sweeps=8)


def _ladder(grids, terms, F, w, dt):
    """Per-level inject_any states + block-Jacobi pinvs (the fused kernel's
    inputs; tests/test_pallas_vcycle.py:15-29)."""
    w_ls, pinvs = [], []
    wl = w
    for l, gl in enumerate(grids):
        w_ls.append(wl)
        pinvs.append(make_block_jacobi(gl, terms, F, dtype=jnp.float32)(
            wl, wl, dt).pinv_planes)
        if l + 1 < len(grids):
            wl = inject_any(grids[l + 1], grids[l])(wl)
    return w_ls, pinvs


def _inputs(n, seed):
    pj = make_jax(nx=n, ny=n, Lx=2.0 * n, Ly=2.0 * n)
    w = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    return pj, w, r


def _port_build(n, **kw):
    pt = make_torch(nx=n, ny=n, Lx=2.0 * n, Ly=2.0 * n)
    return pt, make_gmg(pt.grid, pt.terms, 2, device="cpu",
                        jvp_for=lambda g, split: pt.kernel_jvp(g, "cpu"), **kw)


def test_vcycle_pair_matches_fused_pallas_16():
    n, F, dt = 16, 2, 0.5
    pj, w, r = _inputs(n, seed=0)
    g = pj.grid
    grids = [dataclasses.replace(gl, rule_name="dunavant2")
             for gl in build_hierarchy(g)]
    assert len(grids) == 2
    fused = make_fused_vcycle(grids, pj.terms, F, **BENCH1_NU,
                              dtype=jnp.float32, with_matvec=True,
                              matvec_grid=g, interpret=True)
    wj = tuple(jnp.asarray(a) for a in w)
    w_ls, pinvs = jax.jit(lambda w_: _ladder(grids, pj.terms, F, w_, dt))(wj)
    zj, azj = fused(tuple(jnp.asarray(a) for a in r), w_ls, w_ls, dt, pinvs)

    _, build = _port_build(n, precond_rule="dunavant2",
                           dense_coarse_max_dofs=0, **BENCH1_NU)
    wt = state_from_numpy(w, "cpu")
    zt, azt = build(wt, wt, dt).minv_matvec(state_from_numpy(r, "cpu"))
    for a, b in zip(state_to_numpy(zt) + state_to_numpy(azt), zj + azj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_vcycle_matches_xla_gmg_32():
    n, F, dt = 32, 2, 0.5
    pj, w, r = _inputs(n, seed=1)
    g = pj.grid
    kw = dict(precond_rule="dunavant2", min_cells=8, dense_coarse_max_dofs=0,
              **BENCH1_NU)
    jbuild = jax_gmg(g, pj.terms, F, dtype=jnp.float32, use_pallas=False, **kw)
    wj = tuple(jnp.asarray(a) for a in w)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, dt)(r_))(
        wj, tuple(jnp.asarray(a) for a in r))
    res32 = jax_residual(g, pj.terms, F, dtype=jnp.float32)
    _, azj = jax.jvp(lambda u: res32(u, wj, dt), (wj,), (zj,))

    _, build = _port_build(n, **kw)
    wt = state_from_numpy(w, "cpu")
    zt, azt = build(wt, wt, dt).minv_matvec(state_from_numpy(r, "cpu"))
    for a, b in zip(state_to_numpy(zt) + state_to_numpy(azt), zj + azj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_dense_coarse_matches_xla_16():
    """Coarsest 8^2 level (290 dofs <= 1500) solved by the dense inverse."""
    n, F, dt = 16, 2, 0.5
    pj, w, r = _inputs(n, seed=2)
    kw = dict(nu_pre=2, nu_post=2, coarse_sweeps=8)
    jbuild = jax_gmg(pj.grid, pj.terms, F, dtype=jnp.float32,
                     use_pallas=False, **kw)
    wj = tuple(jnp.asarray(a) for a in w)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, dt)(r_))(
        wj, tuple(jnp.asarray(a) for a in r))
    _, build = _port_build(n, **kw)
    wt = state_from_numpy(w, "cpu")
    zt = build(wt, wt, dt)(state_from_numpy(r, "cpu"))
    for a, b in zip(state_to_numpy(zt), zj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


@pytest.mark.parametrize("knob", [dict(cycle="w"), dict(inner_mr=2)])
def test_unported_cycles_raise(knob):
    with pytest.raises(NotImplementedError):
        _port_build(16, **knob)
