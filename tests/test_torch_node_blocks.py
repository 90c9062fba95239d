"""Kernel N's plain version and plan (ops/node_blocks.py) on the CPU:

- the tangent form of the 2D block-Jacobi build
  (``solve/precond.make_block_jacobi_tangent``, the benchmark's hand-written
  tangent with one-hot directions, which kernel N computes) against the JAX
  package's ``make_block_jacobi`` (``jax.jvp`` of ``terms``, x64) at rel
  1e-12 in f64, at every level of the hierarchy (min_cells 4): bench1 16^2,
  bench6 16^2 with its Dirichlet rows, bench2 8^2 with 1, 2 and 4 order
  parameters, coupled and field-split, and bench3 16^2;
- the plan's plain version against its library build (the port's
  ``torch.func.jvp`` form, ``make_block_jacobi``) at rtol 2e-4 / atol 2e-5
  in f32, the tolerance of tests/test_pallas_vcycle.py (the two sum in
  different orders);
- the plan on CPU tensors is its plain version, and runs no
  ``torch.func.jvp``; its refusals at construction and at a call on the card
  (stand-in CUDA tensors); what its launcher receives (a recording stand-in
  for the library): the parameter block of the level J.v with dt, the
  variant, the state, diagonal and mask pointers, the node counts, and the
  planes as views of one buffer;
- a numpy transliteration of kernel N's BM1 instantiation as the card runs
  it (csrc/node_blocks_ch.cu: the source column in the order of torch's
  forward mode, P and the elimination with every product and sum rounded in
  f32 on its own) gives the ``torch.func.jvp`` build's bits at every level
  and at dt from 1e-3 to 102.4;
- the slice: the multigrid build on the plans (no ``torch.func.jvp``) and
  one V-cycle apply against the JAX package's XLA GMG at 16^2 (bench1's
  cycle, levels 16/8/4), at the tolerance of tests/test_torch_gmg.py.

Inputs are each level's initial condition plus seeded numpy noise.
"""

import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks import bench1 as jbench1
from pfhubbenchmarks_tpu.benchmarks import bench2 as jbench2
from pfhubbenchmarks_tpu.benchmarks import bench3 as jbench3
from pfhubbenchmarks_tpu.benchmarks import bench6 as jbench6
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.solve.gmg import build_hierarchy as jax_hierarchy
from pfhubbenchmarks_tpu.solve.gmg import make_gmg as jax_gmg
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench1_3d, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.node_blocks import NodeBlockPlan
from pfhubbenchmarks_tpu_torch.solve.gmg import build_hierarchy, make_gmg
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi_tangent

F32 = dict(rtol=2e-4, atol=2e-5)
DT = 0.05
MIN_CELLS = 4

# name: (port make, JAX make, size, kwargs, split)
CASES = {
    "bench1": (bench1.make, jbench1.make, 16, dict(Lx=32.0, Ly=32.0), False),
    "bench6": (bench6.make, jbench6.make, 16, {}, False),
    "bench3": (bench3.make, jbench3.make, 16, {}, False),
}
for _ne in (1, 2, 4):
    for _split in (False, True):
        CASES[f"bench2_ne{_ne}_{'split' if _split else 'coupled'}"] = (
            bench2.make, jbench2.make, 8, dict(num_eta=_ne), _split)


@functools.cache
def _setup(name):
    """(port problem, JAX problem, split, per level: (port grid, JAX grid,
    w, w0) with numpy f64 states)."""
    make_t, make_j, n, kw, split = CASES[name]
    pt, pj = make_t(nx=n, ny=n, **kw), make_j(nx=n, ny=n, **kw)
    rule = pt.solver.precond_rule
    gts = [dataclasses.replace(g, rule_name=rule)
           for g in build_hierarchy(pt.grid, min_cells=MIN_CELLS)]
    gjs = [dataclasses.replace(g, rule_name=rule)
           for g in jax_hierarchy(pj.grid, min_cells=MIN_CELLS)]
    assert [g.nx for g in gts] == [g.nx for g in gjs] and len(gts) >= 2
    rng = np.random.default_rng(sorted(CASES).index(name))
    levels = []
    for gt, gj in zip(gts, gjs):
        w0 = tuple(np.asarray(a, np.float64) for a in gt.interpolate(pt.ic_fns))
        w = [a + 0.01 * rng.standard_normal(a.shape) for a in w0]
        v = torch.as_tensor(w[0])
        for bc in pt.dirichlet_for(gt):
            v = bc.apply_value(v)
        w[0] = v.numpy()
        levels.append((gt, gj, tuple(w), w0))
    return pt, pj, split, levels


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _plan(pt, gt, split):
    jv = pt.kernel_jvp(gt, "cpu", pt.dirichlet_for(gt), split=split)
    return NodeBlockPlan(gt, jv, pt.terms_precond if split else pt.terms,
                         device="cpu", dirichlet=pt.dirichlet_for(gt))


@pytest.mark.parametrize("name", sorted(CASES))
def test_tangent_form_matches_jax_f64(name):
    pt, pj, split, levels = _setup(name)
    F = pt.n_fields
    terms_j = pj.terms_precond if split else pj.terms
    # every level's JAX build in one compiled call
    builds_j = [jax_bj(gj, terms_j, F, dirichlet=pj.dirichlet_for(gj),
                       dtype=jnp.float64) for _, gj, _, _ in levels]
    refs = jax.jit(lambda states: [b(w, w0, DT).pinv_planes for b, (w, w0)
                                   in zip(builds_j, states)])(
        [tuple(tuple(jnp.asarray(a) for a in p) for p in (w, w0))
         for _, _, w, w0 in levels])
    for (gt, _, w, w0), ref in zip(levels, refs):
        jv = pt.kernel_jvp(gt, "cpu", pt.dirichlet_for(gt), split=split)
        got = make_block_jacobi_tangent(
            gt, jv.tangent, F, device="cpu", dirichlet=pt.dirichlet_for(gt),
            dtype=torch.float64)(state_from_numpy(w, "cpu", torch.float64),
                                 state_from_numpy(w0, "cpu", torch.float64),
                                 DT).pinv_planes
        for a, b in zip(got, ref):
            assert a.dtype == torch.float64
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-12, (name, gt.nx)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jvp_form_f32(name):
    pt, _, split, levels = _setup(name)
    for gt, _, w, w0 in levels:
        plan = _plan(pt, gt, split)
        wt, w0t = (state_from_numpy(a, "cpu", torch.float32) for a in (w, w0))
        got, ref = plan.plain(wt, w0t, DT), plan.library(wt, w0t, DT)
        for a, b in zip(got, ref):
            assert a.dtype == torch.float32 and a.is_contiguous()
            assert a.shape == b.shape == (pt.n_fields,) + tuple(b.shape[1:])
            np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
        if split:   # the cross-group planes are exact zeros, kept
            groups = [0, 0] + list(range(1, pt.n_fields - 1))
            for i in range(pt.n_fields):
                for j in range(pt.n_fields):
                    if groups[i] != groups[j]:
                        assert not got[0][i, j].any() and not got[1][i, j].any()


def test_plan_on_cpu_is_the_plain_version_without_jvp():
    pt, _, _, levels = _setup("bench6")
    gt, _, w, w0 = levels[0]
    plan = _plan(pt, gt, False)
    wt, w0t = (state_from_numpy(a, "cpu", torch.float32) for a in (w, w0))
    _lib.reset_launches()
    got = plan(wt, w0t, DT)
    assert _lib.SECONDS["jvp_blocks"] == 0.0
    assert _lib.LAUNCHES["node_blocks"] == 0
    for a, b in zip(got, plan.plain(wt, w0t, DT)):
        assert torch.equal(a, b)
    # the Dirichlet vertices of phi keep the unit row
    F = pt.n_fields
    pv = got[0]
    np.testing.assert_array_equal(pv[2, :, :, 0].numpy(),
                                  np.broadcast_to([0.0, 0.0, 1.0],
                                                  (gt.ny + 1, F)).T)
    plan.library(wt, w0t, DT)
    assert _lib.SECONDS["jvp_blocks"] > 0.0
    _lib.reset_launches()


class _OnCard:
    """A CPU tensor that reports itself as a CUDA tensor on ``device``: what
    a plan's per-call check reads (as in tests/test_torch_transfer_plan.py)."""

    def __init__(self, t, device=0):
        self.t, self.dev = t, device
        self.is_cuda, self.is_cpu = True, False
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda", device)

    def is_contiguous(self):
        return self.t.is_contiguous()

    def get_device(self):
        return self.dev


def test_plan_refusals():
    pt, _, _, levels = _setup("bench1")
    gt, _, w, _ = levels[0]
    plan = _plan(pt, gt, False)
    F = pt.n_fields
    wt = state_from_numpy(w, "cpu", torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        plan.kernel(wt, wt, DT)
    good = tuple(_OnCard(t) for t in wt)
    with pytest.raises(ValueError, match="plan's tensors are on cpu"):
        plan.check(good)
    plan.diag = _OnCard(plan.diag)
    assert plan.check(good) == 0
    with pytest.raises(ValueError, match="shape"):
        plan.check((good[0], _OnCard(torch.zeros((F,) + levels[1][0].mshape))))
    with pytest.raises(ValueError, match="dtype"):
        plan.check(tuple(_OnCard(t.double()) for t in wt))
    v = torch.zeros((F,) + gt.vshape[::-1]).transpose(1, 2)
    with pytest.raises(ValueError, match="non-contiguous"):
        plan.check((_OnCard(v), good[1]))
    with pytest.raises(ValueError, match="cuda:1"):
        plan.check((good[0], _OnCard(wt[1], device=1)))
    # construction: no 3D instantiation, a J.v of another grid
    p3 = bench1_3d.make(nx=4, ny=4, nz=4)
    with pytest.raises(NotImplementedError, match="ch3d"):
        NodeBlockPlan(gt, p3.kernel_jvp(p3.grid, "cpu"), p3.terms, device="cpu")
    with pytest.raises(ValueError, match="J.v of"):
        NodeBlockPlan(levels[1][0], pt.kernel_jvp(gt, "cpu"), pt.terms,
                      device="cpu")


class _Recorder:
    """Stands in for the kernel library: records each launcher's name, the
    parameter block (copied out while it is alive) and the other
    arguments."""

    def __init__(self, param_floats):
        self.calls, self.param_floats, self.lib = [], param_floats, self

    def pfh_jvp_param_floats(self):
        return self.param_floats

    def __getattr__(self, name):
        def launcher(params, *args):
            block = np.ctypeslib.as_array((ctypes.c_float * self.param_floats)
                                          .from_address(params)).copy()
            self.calls.append((name, block, args))
            return 0
        return launcher


@pytest.mark.parametrize("name", ["bench1", "bench6", "bench2_ne4_split",
                                  "bench2_ne2_coupled", "bench3"])
def test_plan_launch_arguments(name, monkeypatch):
    pt, _, split, levels = _setup(name)
    gt, _, w, w0 = levels[0]
    plan = _plan(pt, gt, split)
    launch = pt.kernel_jvp(gt, "cpu", pt.dirichlet_for(gt), split=split).launch
    rec = _Recorder(launch.head.size + 1)
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "stream_handle", lambda: 7)
    monkeypatch.setattr(plan, "check", lambda w_: 0)
    wt = state_from_numpy(w, "cpu", torch.float32)
    _lib.reset_launches()
    pv, pm = plan.kernel(wt, wt, DT)
    assert _lib.LAUNCHES["node_blocks"] == 1
    _lib.reset_launches()
    ((symbol, block, args),) = rec.calls
    assert symbol == f"pfh_node_blocks_{launch.kind}"
    np.testing.assert_array_equal(block[:-1], launch.head)
    assert block[-1] == np.float32(DT)
    n_var = len(launch.variant)
    assert args[:n_var] == launch.variant
    if name.startswith("bench2"):
        assert launch.variant == (pt.n_fields - 2, int(split))
    mask = plan.mask
    assert (mask is not None) == (name == "bench6")
    nvert, ncell = (gt.ny + 1) * (gt.nx + 1), gt.ny * gt.nx
    assert args[n_var:] == (wt[0].data_ptr(), wt[1].data_ptr(),
                            plan.diag.data_ptr(),
                            None if mask is None else mask.data_ptr(),
                            pv.data_ptr(), pm.data_ptr(), nvert, ncell, 7)
    F = pt.n_fields
    assert pv.shape == (F, F) + gt.vshape and pm.shape == (F, F) + gt.mshape
    assert pv.is_contiguous() and pm.is_contiguous()
    assert pm.data_ptr() == pv.data_ptr() + 4 * F * F * nvert
    # the diagonals: mass, stiff_xx, stiff_yy, vertices then centres
    assert plan.diag.shape == (3, nvert + ncell)
    d = gt.node_diagonals()
    np.testing.assert_allclose(
        plan.diag[1].numpy(),
        np.concatenate([d["stiff_xx"][0].ravel(), d["stiff_xx"][1].ravel()]),
        rtol=1e-6)


def _ch_exact_blocks(u, mass, sxx, syy, k, dt):
    """Kernel N's BM1 blocks [..., 2, 2] as csrc/node_blocks_ch.cu computes
    them: numpy f32 scalars and arrays round every operation on its own."""
    f32 = np.float32
    M, kappa, rho_s, ca, cb = (f32(x) for x in k)
    c = u[0]
    K = f32(2.0) * rho_s
    A = c - ca
    B = cb - c
    X1 = A * K
    X2 = X1 * B
    C = B - A
    dX2 = -X1 + K * B
    d_dfdc = f32(-2.0) * X2 + dX2 * C
    src = [[np.full_like(c, f32(1.0) / f32(dt)), np.zeros_like(c)],
           [-d_dfdc, np.ones_like(c)]]          # src[i][j]
    fx = [[f32(0.0), M], [-kappa, f32(0.0)]]      # flux x in gx = e_j
    P = np.empty(c.shape + (2, 2), f32)
    for i in range(2):
        for j in range(2):
            P[..., i, j] = (src[i][j] * mass + fx[i][j] * sxx) + fx[i][j] * syy
    aug = np.concatenate([P, np.broadcast_to(np.eye(2, dtype=f32), P.shape)],
                         axis=-1)
    for i in range(2):
        piv = aug[..., i, :] / aug[..., i, i][..., None]
        rows = [piv if r == i else aug[..., r, :] - aug[..., r, i][..., None] * piv
                for r in range(2)]
        aug = np.stack(rows, axis=-2)
    return aug[..., 2:]


def test_ch_exact_order_gives_the_jvp_build_bits():
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import (Bench1Params,
                                                             kernel_constants)
    from pfhubbenchmarks_tpu_torch.ops.ch_jvp import CONSTANTS
    from pfhubbenchmarks_tpu_torch.solve.precond import padded_diagonals

    pt, _, _, levels = _setup("bench1")
    k = tuple(kernel_constants(Bench1Params())[n] for n in CONSTANTS)
    for gt, _, w, _ in levels:
        plan = _plan(pt, gt, False)
        wt = state_from_numpy(w, "cpu", torch.float32)
        (mv, mm), (xv, xm), (yv, ym) = padded_diagonals(gt, "cpu")
        for dt in (1e-3, 0.37, 3.2, 102.4):
            dt = float(np.float32(dt))
            ref = plan.library(wt, wt, dt)
            for u, d, r in zip(wt, ((mv, xv, yv), (mm, xm, ym)), ref):
                blocks = _ch_exact_blocks(u.numpy(), *(a.numpy() for a in d),
                                          k, dt)
                np.testing.assert_array_equal(
                    np.moveaxis(blocks, (-2, -1), (0, 1)), r.numpy())


def test_slice_vcycle_on_plans_matches_xla_gmg_16():
    n, F, dt = 16, 2, 0.5
    pj = jbench1.make(nx=n, ny=n, Lx=2.0 * n, Ly=2.0 * n)
    pt = bench1.make(nx=n, ny=n, Lx=2.0 * n, Ly=2.0 * n)
    w = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(16)
    w = tuple(a + np.float32(0.01) * rng.standard_normal(a.shape).astype(
        np.float32) for a in w)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    kw = dict(precond_rule="dunavant2", min_cells=MIN_CELLS,
              dense_coarse_max_dofs=0, nu_pre=3, nu_post=3, nu_fine_pre=1,
              coarse_sweeps=8)
    jbuild = jax_gmg(pj.grid, pj.terms, F, dtype=jnp.float32,
                     use_pallas=False, **kw)
    wj = tuple(jnp.asarray(a) for a in w)
    zj = jax.jit(lambda w_, r_: jbuild(w_, w_, dt)(r_))(
        wj, tuple(jnp.asarray(a) for a in r))
    res32 = jax_residual(pj.grid, pj.terms, F, dtype=jnp.float32)
    _, azj = jax.jvp(lambda u: res32(u, wj, dt), (wj,), (zj,))

    build = make_gmg(pt.grid, pt.terms, F, device="cpu",
                     jvp_for=lambda g, split: pt.kernel_jvp(g, "cpu"), **kw)
    assert [g.nx for g in build.grids] == [16, 8, 4]
    assert all(isinstance(p, NodeBlockPlan) for p in build.node_blocks)
    wt = state_from_numpy(w, "cpu")
    _lib.reset_launches()
    Minv = build(wt, wt, dt)
    assert _lib.SECONDS["jvp_blocks"] == 0.0 and _lib.SECONDS["precond_build"] > 0
    zt, azt = Minv.minv_matvec(state_from_numpy(r, "cpu"))
    _lib.reset_launches()
    for a, b in zip(state_to_numpy(zt) + state_to_numpy(azt), zj + azj):
        np.testing.assert_allclose(a, np.asarray(b), **F32)
