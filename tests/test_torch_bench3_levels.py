"""The V-cycle's level steps and bench3's whole V-cycle against the JAX
package, on seeded numpy inputs:

- ``make_descend_level`` / ``make_ascend_level`` (ops/vcycle_chain.py;
  plain on the CPU) against the Pallas kernels they replace,
  ``make_fused_descend`` (TPU kernel 6) and ``make_fused_ascend`` (kernel 9)
  in interpret mode, at bench3's physics with the dunavant2 rule and its
  sweep counts (1 fine pre-sweep, 3 post-sweeps), on a dyadic pair (14 ->
  7, kernel D's transfers) and a ratio-5 pair (35 -> 7, kernel H's); and
  the anisotropic bench3's (``anisotropy=True``) on the dyadic pair;
- the port's V-cycle for bench3 at 70^2 (levels 70/35/7, ratios 2 and 5,
  the exact dense 7^2 coarse: 226 dofs) against the JAX package's XLA
  ``make_gmg(use_pallas=False)``, z and the exported A z;
- a level step calls no kernel on the CPU, and its counters stay 0.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.ops.pallas_vcycle import (make_fused_ascend,
                                                   make_fused_descend)
from pfhubbenchmarks_tpu.solve.gmg import make_gmg as jax_gmg
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import make as make_torch
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_level,
                                                        make_descend_level)
from pfhubbenchmarks_tpu_torch.solve.gmg import make_gmg

F32 = dict(rtol=2e-4, atol=2e-5)
F = 2
DT = 0.04


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _noise(g, rng):
    return tuple(rng.standard_normal((F,) + s).astype(np.float32)
                 for s in (g.vshape, g.mshape))


def _state(g, seed):
    """bench3's IC on ``g`` plus seeded noise, f32 numpy."""
    v, m = g.interpolate(make_jax(nx=g.nx, ny=g.ny).ic_fns)
    rng = np.random.default_rng(seed)
    return tuple((a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
                 for a in (v, m))


def _level_steps_vs_pallas(nf, nc, **kw):
    """The level steps of bench3 (``kw``: its options) on (nf -> nc)
    against ``make_fused_descend`` / ``make_fused_ascend`` in interpret
    mode."""
    pj, pt = make_jax(nx=nf, ny=nf, **kw), make_torch(nx=nf, ny=nf, **kw)
    jfine = dataclasses.replace(pj.grid, rule_name="dunavant2")
    jcoarse = dataclasses.replace(jfine, nx=nc, ny=nc)
    tfine = dataclasses.replace(pt.grid, rule_name="dunavant2")
    tcoarse = dataclasses.replace(tfine, nx=nc, ny=nc)
    w = _state(tfine, seed=nf)
    pinv = tuple(np.asarray(a) for a in jax.jit(lambda w_: jax_bj(
        jfine, pj.terms, F, dtype=jnp.float32)(w_, w_, DT).pinv_planes)(_j(w)))
    rng = np.random.default_rng(nf + nc)
    b, xc = _noise(tfine, rng), _noise(tcoarse, rng)
    s = pj.solver
    nu_pre = s.gmg_nu_fine_pre or s.gmg_nu_pre
    nu_post = s.gmg_nu_fine_post or s.gmg_nu_post
    assert (nu_pre, nu_post) == (1, 3)

    jd = make_fused_descend(jfine, jcoarse, pj.terms, F, nu=nu_pre,
                            interpret=True)
    ja = make_fused_ascend(jfine, jcoarse, pj.terms, F, nu=nu_post,
                           interpret=True)
    x_j, bc_j = jd(_j(b), _j(w), _j(w), DT, _j(pinv))
    z_j = ja(_j(b), x_j, _j(xc), _j(w), _j(w), DT, _j(pinv))

    jv = pt.kernel_jvp(tfine, "cpu")
    td = make_descend_level(tfine, tcoarse, jv, nu=nu_pre)
    ta = make_ascend_level(tfine, tcoarse, jv, nu=nu_post)
    _lib.reset_launches()
    x_t, bc_t = td(_t(b), _t(w), _t(w), DT, _t(pinv))
    # the ascent starts from the JAX descent's iterate, so each step is
    # compared on its own
    z_t = ta(_t(b), _t(tuple(np.asarray(a) for a in x_j)), _t(xc), _t(w),
             _t(w), DT, _t(pinv))
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())
    for got, ref in ((x_t, x_j), (bc_t, bc_j), (z_t, z_j)):
        assert tuple(got[0].shape) == tuple(ref[0].shape)
        for a, r in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(r), **F32)


@pytest.mark.parametrize("nf,nc", [(14, 7), (35, 7)])
def test_level_steps_match_pallas_level_kernels(nf, nc):
    _level_steps_vs_pallas(nf, nc)


def test_aniso_level_steps_match_pallas_level_kernels():
    """The anisotropic bench3's level steps (the physics "acha", whose
    tangent reads the state's gradient) against the Pallas level kernels
    taking ``jax.jvp`` of the anisotropic terms, on the dyadic pair."""
    _level_steps_vs_pallas(14, 7, anisotropy=True)


def test_bench3_vcycle_with_dense_coarse_matches_xla_gmg():
    n = 70
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w = _state(pt.grid, seed=4)
    rng = np.random.default_rng(6)
    r = _noise(pt.grid, rng)
    s = pt.solver
    kw = dict(precond_rule=s.precond_rule, nu_pre=s.gmg_nu_pre,
              nu_post=s.gmg_nu_post, nu_fine_pre=s.gmg_nu_fine_pre)
    jbuild = jax_gmg(pj.grid, pj.terms, F, dtype=jnp.float32,
                     use_pallas=False, **kw)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, DT)(r_))(_j(w), _j(r))
    res32 = jax_residual(pj.grid, pj.terms, F, dtype=jnp.float32)
    _, azj = jax.jvp(lambda u: res32(u, _j(w), DT), (_j(w),), (zj,))

    tbuild = make_gmg(pt.grid, pt.terms, F, device="cpu",
                      jvp_for=lambda g, split: pt.kernel_jvp(g, "cpu"), **kw)
    assert [g.nx for g in tbuild.grids] == [70, 35, 7] and tbuild.dense_coarse
    zt, azt = tbuild(_t(w), _t(w), DT).minv_matvec(_t(r))
    for a, b in zip(state_to_numpy(zt) + state_to_numpy(azt), zj + azj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)
