"""The port's bench6 pieces against the JAX package, on seeded numpy inputs:

- f64 residual with the Dirichlet rows of phi, TFE and solute at 24^2
  (rel 1e-12);
- block-Jacobi planes with unit BC rows (f32 tolerance);
- the hand-written CH+Poisson tangent against ``torch.func.jvp`` (f64);
- kernel E's plain version (``chp_jvp``) against ``make_pallas_jvp`` in
  interpret mode with the BC rows re-set as ``benchmarks/base.py:205-213``
  does, both rules, both forms, at 16^2;
- the masked transfers against ``solve/transfer.py`` plus ``zero_bc_rows``
  (exact in f64);
- ``descend_chain`` / ``ascend_chain`` (plain on the CPU) against the Pallas
  chain kernels in interpret mode on a 16/8/4 hierarchy;
- the split_chain GMG apply against the XLA ``make_gmg`` at 24^2;
- bench6's 100^2 build: hierarchy 100/50/25, no dense coarse.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu.ops.pallas_vcycle import (make_fused_ascend_chain,
                                                   make_fused_descend_chain)
from pfhubbenchmarks_tpu.solve import transfer as jtransfer
from pfhubbenchmarks_tpu.solve.gmg import build_hierarchy as jax_hierarchy
from pfhubbenchmarks_tpu.solve.gmg import make_gmg as jax_gmg
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu.solve.transfer import inject_any
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import (Bench6Params,
                                                         kernel_constants,
                                                         make as make_torch,
                                                         make_terms)
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext, bc_mask
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops.chp_jvp import make_chp_jvp
from pfhubbenchmarks_tpu_torch.ops.transfer import prolong, restrict
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                        make_descend_chain)
from pfhubbenchmarks_tpu_torch.solve.gmg import make_gmg
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
F = 3


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair, dtype=torch.float32):
    return state_from_numpy(pair, "cpu", dtype)


def _with_bcs(pj, grid, w):
    """Set the Dirichlet values of ``grid`` into a numpy state."""
    v = jnp.asarray(w[0])
    for bc in pj.dirichlet_for(grid):
        v = bc.apply_value(v)
    return np.asarray(v), w[1]


def _states(n, seed, dtype=np.float32):
    """(w, w0, v): bench6's IC plus seeded noise with the BC values kept,
    the IC itself, and a random direction."""
    pj = make_jax(nx=n, ny=n)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = _with_bcs(pj, pj.grid, tuple(a + 0.02 * rng.standard_normal(a.shape)
                                     for a in w0))
    v = tuple(rng.standard_normal(a.shape) for a in w0)
    return tuple(tuple(a.astype(dtype) for a in p) for p in (w, w0, v))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_residual_and_observables_match_jax_f64():
    n = 24
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, w0, _ = _states(n, seed=0, dtype=np.float64)
    rj = pj.residual()(_j(w), _j(w0), 0.05)
    rt = pt.residual("cpu")(_t(w, torch.float64), _t(w0, torch.float64), 0.05)
    for a, b in zip(state_to_numpy(rt), rj):
        assert _rel(a, np.asarray(b)) <= 1e-12
    # the BC rows hold u - g
    for bc in pt.dirichlet:
        g = torch.as_tensor(bc.g)
        torch.testing.assert_close(bc.rows(rt[0]), bc.rows(_t(w, torch.float64)[0]) - g,
                                   rtol=0, atol=0)
    obs_j = {k: float(f(_j(w))) for k, f in pj.observable_fns().items()}
    obs_t = {k: float(f(_t(w, torch.float64)))
             for k, f in pt.observable_fns("cpu").items()}
    assert obs_j.keys() == obs_t.keys()
    for k in obs_j:
        assert abs(obs_t[k] - obs_j[k]) <= 1e-12 * abs(obs_j[k])
    # the initial state carries the BC values
    for a, b in zip(state_to_numpy(pt.initial_state("cpu")), pj.initial_state()):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_block_jacobi_bc_rows_match_jax():
    n = 16
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, w0, _ = _states(n, seed=1)
    dt = 0.05
    planes_j = jax.jit(lambda a, b: jax_bj(
        pj.grid, pj.terms, F, dirichlet=pj.dirichlet,
        dtype=jnp.float32)(a, b, dt).pinv_planes)(_j(w), _j(w0))
    mt = make_block_jacobi(pt.grid, pt.terms, F, device="cpu",
                           dirichlet=pt.dirichlet)(_t(w), _t(w0), dt)
    for a, b in zip(mt.pinv_planes, planes_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    # a BC vertex's block inverse keeps the unit row of phi
    pv = mt.pinv_planes[0]
    np.testing.assert_array_equal(pv[2, :, :, 0].numpy(),
                                  np.broadcast_to([0.0, 0.0, 1.0], (n + 1, 3)).T)


def test_terms_tangent_matches_jvp():
    terms, terms_tangent, _ = make_terms(Bench6Params())
    rng = np.random.default_rng(3)
    shape = (4, 3, 5, 6)

    def r(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    u = (0.5 + 0.1 * r(*shape), r(*shape), r(*shape))
    du = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(F))
    u0 = (0.5 + 0.1 * r(*shape), r(*shape), r(*shape))
    du0 = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(F))
    tu = tuple(r(*shape) for _ in range(F))
    tdu = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(F))
    dt = 0.37

    def flat(u_, du_):
        s, f = terms(QPContext(u=u_, du=du_, u0=u0, du0=du0, dt=dt))
        return tuple(s) + tuple(x for fi in f for x in fi)

    _, ref = torch.func.jvp(flat, (u, du), (tu, tdu))
    ctx = QPContext(u=u, du=du, u0=u0, du0=du0, dt=dt)
    s, f = terms_tangent(ctx, QPContext(u=tu, du=tdu, u0=None, du0=None, dt=None))
    got = tuple(s) + tuple(x for fi in f for x in fi)
    for a, b in zip(got, ref):
        a, b = torch.broadcast_tensors(a, b)
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)


@pytest.mark.parametrize("rule", ["ffc3", "dunavant2"])
def test_chp_jvp_matches_pallas_jvp(rule):
    n = 16
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    w, w0, v = _states(n, seed=2)
    dt = 0.05
    pallas_jv = make_pallas_jvp(gj, pj.terms, F)
    rv, rm = pallas_jv(_j(w), _j(w0), dt, _j(v), interpret=True)
    for bc in pj.dirichlet_for(gj):   # benchmarks/base.py:205-213
        rv = rv.at[bc.field, :, bc.index].set(jnp.asarray(v[0])[bc.field, :, bc.index])
    ref = (np.asarray(rv), np.asarray(rm))
    jv = make_chp_jvp(gt, make_terms(Bench6Params())[1],
                      kernel_constants(Bench6Params()),
                      device="cpu", dirichlet=pt.dirichlet_for(gt))
    out = jv(_t(w), _t(w0), dt, _t(v))
    for a, b in zip(state_to_numpy(out), ref):
        np.testing.assert_allclose(a, b, **F32)
    res = jv(_t(w), _t(w0), dt, _t(v), b=_t(w0))   # the form b - J v
    for a, b, c in zip(state_to_numpy(res), w0, ref):
        np.testing.assert_allclose(a, b - c, **F32)
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(_t(w), _t(w0), dt, _t(v))


def _pair_grids(n=16):
    pt, pj = make_torch(nx=n, ny=n), make_jax(nx=n, ny=n)
    half = dict(nx=n // 2, ny=n // 2)
    return (pt, pj, pt.grid, dataclasses.replace(pt.grid, **half),
            pj.grid, dataclasses.replace(pj.grid, **half))


def _zero_bc_rows(bcs, w):
    """``solve/gmg.py:zero_bc_rows`` on a numpy pair."""
    rv = np.array(w[0])
    for bc in bcs:
        if bc.side in ("left", "right"):
            rv[bc.field, :, bc.index] = 0.0
        else:
            rv[bc.field, bc.index, :] = 0.0
    return rv, np.asarray(w[1])


@pytest.mark.parametrize("op", ["restrict", "prolong", "prolong+="])
def test_masked_transfers_match_jax_f64(op):
    pt, pj, fine, coarse, jfine, jcoarse = _pair_grids()
    rng = np.random.default_rng(11)
    src_g = coarse if op.startswith("prolong") else fine
    src = tuple(rng.standard_normal((F,) + s) for s in (src_g.vshape, src_g.mshape))
    dst_g, jdst = (fine, jfine) if op.startswith("prolong") else (coarse, jcoarse)
    mask = torch.as_tensor(bc_mask(dst_g, pt.dirichlet_for(dst_g), F),
                           dtype=torch.float64)
    jfn = (jtransfer.prolong if op.startswith("prolong")
           else jtransfer.restrict)(jcoarse, jfine)
    ref = _zero_bc_rows(pj.dirichlet_for(jdst), jfn(_j(src)))
    if op == "restrict":
        got = restrict(_t(src, torch.float64), coarse, fine, mask)
    elif op == "prolong":
        got = prolong(_t(src, torch.float64), coarse, fine, mask=mask)
    else:
        base = tuple(rng.standard_normal((F,) + s) for s in (fine.vshape, fine.mshape))
        got = prolong(_t(src, torch.float64), coarse, fine,
                      out=_t(base, torch.float64), mask=mask)
        ref = tuple(a + b for a, b in zip(base, ref))
    for a, b in zip(state_to_numpy(got), ref):
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(b).max(), 1.0)


def _chain_setup(n=16, min_cells=4, seed=5):
    """A 16/8/4 dunavant2 hierarchy, per-level injected states and
    block-Jacobi planes from the JAX package (tests/test_pallas_vcycle.py's
    ``_ladder``), carried across as numpy."""
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    jgrids = [dataclasses.replace(g, rule_name="dunavant2")
              for g in jax_hierarchy(pj.grid, min_cells=min_cells)]
    tgrids = [dataclasses.replace(pt.grid, nx=g.nx, ny=g.ny, rule_name="dunavant2")
              for g in jgrids]
    assert [g.nx for g in tgrids] == [16, 8, 4]
    jbcs = [pj.dirichlet_for(g) for g in jgrids]
    w, _, _ = _states(n, seed)
    dt = 0.05

    @jax.jit
    def ladder(w_):
        w_ls, pinvs = [], []
        wl = w_
        for l, gl in enumerate(jgrids):
            w_ls.append(wl)
            pinvs.append(jax_bj(gl, pj.terms, F, dirichlet=jbcs[l],
                                dtype=jnp.float32)(wl, wl, dt).pinv_planes)
            if l + 1 < len(jgrids):
                wl = inject_any(jgrids[l + 1], jgrids[l])(wl)
        return w_ls, pinvs

    w_ls, pinvs = ladder(_j(w))
    np_ls = [tuple(np.asarray(a) for a in p) for p in w_ls]
    np_pinvs = [tuple(np.asarray(a) for a in p) for p in pinvs]
    jvs = [pt.kernel_jvp(g, "cpu", pt.dirichlet_for(g)) for g in tgrids]
    masks = [None if m is None else torch.as_tensor(m)
             for m in (bc_mask(g, pt.dirichlet_for(g), F) for g in tgrids)]
    return pj, jgrids, jbcs, tgrids, jvs, masks, np_ls, np_pinvs, dt


def test_vcycle_chains_match_pallas_chains():
    pj, jgrids, jbcs, tgrids, jvs, masks, w_ls, pinvs, dt = _chain_setup()
    K = len(jgrids) - 1
    nu = dict(nu=2, nu_fine=1)
    rng = np.random.default_rng(9)
    g0 = tgrids[0]
    b = tuple(rng.standard_normal((F,) + s).astype(np.float32)
              for s in (g0.vshape, g0.mshape))
    gc = tgrids[-1]
    xc = tuple(rng.standard_normal((F,) + s).astype(np.float32)
               for s in (gc.vshape, gc.mshape))

    jd = make_fused_descend_chain(jgrids, pj.terms, F, level_bcs=jbcs,
                                  interpret=True, **nu)
    ja = make_fused_ascend_chain(jgrids, pj.terms, F, level_bcs=jbcs,
                                 interpret=True, **nu)
    jw, jp = [_j(p) for p in w_ls[:K]], [_j(p) for p in pinvs[:K]]
    xs_j, bs_j, bc_j = jd(_j(b), jw, jw, dt, jp)
    z_j = ja([_j(b)] + list(bs_j), xs_j, _j(xc), jw, jw, dt, jp)

    td = make_descend_chain(tgrids, jvs, masks=masks, **nu)
    ta = make_ascend_chain(tgrids, jvs, masks=masks, **nu)
    tw, tp = [_t(p) for p in w_ls[:K]], [_t(p) for p in pinvs[:K]]
    xs_t, bs_t, bc_t = td(_t(b), tw, tw, dt, tp)
    # the ascent starts from the JAX descent's outputs, so each chain is
    # compared on its own
    z_t = ta([_t(b)] + [_t(tuple(np.asarray(a) for a in p)) for p in bs_j],
             [_t(tuple(np.asarray(a) for a in p)) for p in xs_j], _t(xc),
             tw, tw, dt, tp)

    assert len(xs_t) == K and len(bs_t) == K - 1
    for got, ref in zip(list(xs_t) + list(bs_t) + [bc_t, z_t],
                        list(xs_j) + list(bs_j) + [bc_j, z_j]):
        for a, b_ in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(b_), **F32)


def test_split_chain_gmg_matches_xla_gmg():
    n, dt = 24, 0.05
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, _, _ = _states(n, seed=7)
    rng = np.random.default_rng(8)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    kw = dict(precond_rule="dunavant2", min_cells=6, dense_coarse_max_dofs=0,
              nu_pre=2, nu_post=2, coarse_sweeps=24)
    jbuild = jax_gmg(pj.grid, pj.terms, F, dirichlet_for=pj.dirichlet_for,
                     dtype=jnp.float32, use_pallas=False, **kw)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, dt)(r_))(_j(w), _j(r))
    tbuild = make_gmg(pt.grid, pt.terms, F, device="cpu",
                      jvp_for=lambda g, split: pt.kernel_jvp(g, "cpu", pt.dirichlet_for(g)),
                      dirichlet_for=pt.dirichlet_for, **kw)
    assert [g.nx for g in tbuild.grids] == [24, 12, 6] and not tbuild.dense_coarse
    Minv = tbuild(_t(w), _t(w), dt)
    assert not hasattr(Minv, "minv_matvec")   # BC rows on the fine level
    zt = Minv(_t(r))
    for a, b in zip(state_to_numpy(zt), zj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)


def test_bench6_hierarchy_has_no_dense_coarse():
    pt = make_torch()
    s = pt.solver
    assert (s.fuse_vcycle, s.gmg_min_cells, s.gmg_dense_coarse_max_dofs) == (
        "split_chain", 25, 3000)
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [100, 50, 25]
    assert not build.dense_coarse   # 3 (26^2 + 25^2) = 3903 dofs > 3000
