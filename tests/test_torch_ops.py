"""The plain PyTorch versions of the port's four CUDA kernels against the
JAX package, on seeded numpy inputs at 16^2:

A  ch_jvp             vs ops/pallas_residual.make_pallas_jvp (interpret mode)
   terms_tangent      vs torch.func.jvp of the ported terms (f64, 1e-12)
B  block_jacobi_apply vs solve/precond.make_block_jacobi + _bj_apply
C  lmr_step           vs ops/pallas_vcycle._lmr_alpha and the sweep axpys
D  transfers          vs solve/transfer.py (f64, rel 1e-14, adjointness)

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders. On this CPU the
wrappers run the plain versions; the kernels are held against the same
plain versions on the card by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu.ops.pallas_vcycle import _bj_apply, _lmr_alpha
from pfhubbenchmarks_tpu.solve import transfer as jtransfer
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import (Bench1Params,
                                                         kernel_constants,
                                                         make as make_torch,
                                                         make_terms)
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.ch_jvp import make_ch_jvp
from pfhubbenchmarks_tpu_torch.ops.lmr import block_jacobi_apply, lmr_step
from pfhubbenchmarks_tpu_torch.ops.transfer import inject, prolong, restrict
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
N = 16


def _states(dtype=np.float32, seed=0):
    """(w, w0, v) numpy pairs: bench1's IC plus seeded noise, and a random
    direction v."""
    w0 = tuple(np.asarray(a) for a in make_jax(nx=N, ny=N).initial_state())
    rng = np.random.default_rng(seed)
    w = tuple((a + 0.02 * rng.standard_normal(a.shape)).astype(dtype) for a in w0)
    v = tuple(rng.standard_normal(a.shape).astype(dtype) for a in w0)
    return w, tuple(a.astype(dtype) for a in w0), v


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair, dtype=torch.float32):
    return state_from_numpy(pair, "cpu", dtype)


@pytest.mark.parametrize("rule", ["ffc3", "dunavant2"])
def test_ch_jvp_matches_pallas_jvp(rule):
    pj = make_jax(nx=N, ny=N)
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    pt = make_torch(nx=N, ny=N)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    w, w0, v = _states()
    dt = 0.5
    pallas_jv = make_pallas_jvp(gj, pj.terms, 2)
    ref = jax.jit(lambda a, b, c: pallas_jv(a, b, dt, c, interpret=True))(
        _j(w), _j(w0), _j(v))
    jv = make_ch_jvp(gt, make_terms(Bench1Params())[1],
                     kernel_constants(Bench1Params()),
                     device="cpu")
    out = jv(_t(w), _t(w0), dt, _t(v))
    for a, b in zip(state_to_numpy(out), ref):
        np.testing.assert_allclose(a, np.asarray(b), **F32)
    # the residual form b - J v used by the V-cycle
    bt = _t(w0)
    res = jv(_t(w), _t(w0), dt, _t(v), b=bt)
    for a, b, c in zip(state_to_numpy(res), w0, ref):
        np.testing.assert_allclose(a, b - np.asarray(c), **F32)


def test_kernel_path_refuses_cpu_tensors():
    """No silent fallback: the kernel entry point never takes CPU tensors."""
    pt = make_torch(nx=N, ny=N)
    jv = make_ch_jvp(pt.grid, make_terms(Bench1Params())[1],
                     kernel_constants(Bench1Params()),
                     device="cpu")
    w, w0, v = _states()
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(_t(w), _t(w0), 0.5, _t(v))


def test_terms_tangent_matches_jvp():
    terms, terms_tangent, _, _ = make_terms(Bench1Params())
    rng = np.random.default_rng(3)
    shape = (4, 3, 5, 6)

    def r(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    u = (0.5 + 0.1 * r(*shape), r(*shape))
    du = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(2))
    u0 = (0.5 + 0.1 * r(*shape), r(*shape))
    du0 = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(2))
    tu = (r(*shape), r(*shape))
    tdu = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(2))
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


def test_block_jacobi_planes_and_apply_match_jax():
    pj = make_jax(nx=N, ny=N)
    pt = make_torch(nx=N, ny=N)
    w, w0, r = _states(seed=5)
    dt = 0.5
    jbuild = jax_bj(pj.grid, pj.terms, 2, dtype=jnp.float32)
    planes_j, zj = jax.jit(lambda w_, w0_, r_: (
        lambda m: (m.pinv_planes, _bj_apply(m.pinv_planes, r_, 2)))(
            jbuild(w_, w0_, dt)))(_j(w), _j(w0), _j(r))
    mt = make_block_jacobi(pt.grid, pt.terms, 2, device="cpu")(_t(w), _t(w0), dt)
    for a, b in zip(mt.pinv_planes, planes_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    zt = block_jacobi_apply(mt.pinv_planes, _t(r))
    for a, b in zip(zt, zj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_lmr_step_matches_jax():
    rng = np.random.default_rng(7)
    x, r, z, az = (tuple(rng.standard_normal(s).astype(np.float32)
                         for s in ((2, N + 1, N + 1), (2, N, N)))
                   for _ in range(4))
    alpha = _lmr_alpha(jnp.asarray(az[0]), jnp.asarray(az[1]),
                       jnp.asarray(r[0]), jnp.asarray(r[1]), None)
    x_ref = tuple(np.asarray(a + alpha * b) for a, b in zip(x, z))
    r_ref = tuple(np.asarray(a - alpha * b) for a, b in zip(r, az))
    xt, rt = _t(x), _t(r)
    lmr_step(xt, rt, _t(z), _t(az))
    for got, ref in ((xt, x_ref), (rt, r_ref)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b, **F32)
    # the den > 0 guard: a zero Az leaves (x, r) unchanged
    xt, rt = _t(x), _t(r)
    lmr_step(xt, rt, _t(z), tuple(torch.zeros_like(a) for a in xt))
    for a, b in zip(xt + rt, x + r):
        np.testing.assert_array_equal(a.numpy(), b)


def _pair_grids():
    pt = make_torch(nx=N, ny=N)
    fine = pt.grid
    coarse = dataclasses.replace(fine, nx=N // 2, ny=N // 2)
    pj = make_jax(nx=N, ny=N)
    jfine = pj.grid
    jcoarse = dataclasses.replace(jfine, nx=N // 2, ny=N // 2)
    return coarse, fine, jcoarse, jfine


def _rand_pair(g, rng):
    return (rng.standard_normal((2,) + g.vshape), rng.standard_normal((2,) + g.mshape))


@pytest.mark.parametrize("op", ["prolong", "restrict", "inject"])
def test_transfer_matches_jax_f64(op):
    coarse, fine, jcoarse, jfine = _pair_grids()
    rng = np.random.default_rng(11)
    src = _rand_pair(coarse if op == "prolong" else fine, rng)
    jfn = {"prolong": jtransfer.prolong, "restrict": jtransfer.restrict,
           "inject": jtransfer.inject_state}[op](jcoarse, jfine)
    tfn = {"prolong": prolong, "restrict": restrict, "inject": inject}[op]
    ref = jfn(_j(src))
    got = tfn(_t(src, torch.float64), coarse, fine)
    for a, b in zip(state_to_numpy(got), ref):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(b).max(), 1.0)


def test_restrict_is_transpose_of_prolong():
    coarse, fine, _, _ = _pair_grids()
    rng = np.random.default_rng(13)
    vc = _t(_rand_pair(coarse, rng), torch.float64)
    wf = _t(_rand_pair(fine, rng), torch.float64)
    lhs = sum(float((a * b).sum()) for a, b in zip(prolong(vc, coarse, fine), wf))
    rhs = sum(float((a * b).sum()) for a, b in zip(vc, restrict(wf, coarse, fine)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    # accumulate form: out += P vc
    out = tuple(a.clone() for a in wf)
    prolong(vc, coarse, fine, out=out)
    for o, a, p in zip(out, wf, prolong(vc, coarse, fine)):
        torch.testing.assert_close(o, a + p, rtol=0, atol=1e-15)


def test_launch_counters_untouched_by_plain_versions():
    _lib.reset_launches()
    coarse, fine, _, _ = _pair_grids()
    rng = np.random.default_rng(17)
    prolong(_t(_rand_pair(coarse, rng)), coarse, fine)
    assert all(n == 0 for n in _lib.LAUNCHES.values())
    assert set(_lib.LAUNCHES) == {"ch_jvp", "chp_jvp", "chac_jvp", "ach_jvp",
                                  "ch3d_jvp", "ch3d_tile",
                                  "block_jacobi_apply", "lmr_step",
                                  "lmr_sweep", "transfer_dyadic",
                                  "transfer_general",
                                  "residual", "tile_jvp_recompute",
                                  "tile_jvp_seam", "tile_sweep", "fma_chain",
                                  "shard_sweep", "gridjvp_probe",
                                  "vcycle_descend_chain", "vcycle_ascend_chain",
                                  "node_blocks", "tri_box", "residual_box",
                                  "vcycle_fused", "acha_jvp", "tri_box_acha",
                                  "vcycle_descend_chain_acha",
                                  "vcycle_ascend_chain_acha", "node_build",
                                  "tri_box_chp", "chp3d_tile",
                                  "lmr_loop_chp3d"}
    assert set(_lib.CALLS) == {"tile_sweep_loop", "descend_level",
                               "ascend_level", "descend_chain", "ascend_chain"}
