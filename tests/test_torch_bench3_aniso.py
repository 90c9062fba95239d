"""The anisotropic BM3 (``bench3.make(anisotropy=True)``: the four-fold
a(theta), theta = atan2(phi_y, phi_x), with the Kobayashi rotation flux)
against the JAX package, on seeded numpy inputs:

- the f64 residual, TFE and solid fraction against the JAX package's at
  24^2 on a 12 x 12 domain (the seed's interface resolved), on a state with
  exact-zero gradients in the bulk and noise at the interface (rel 1e-12);
- the hand-written tangent against ``torch.func.jvp`` of the ported
  ``terms`` (f64, 1e-12), with triangles on both sides of the 1e-20 cut;
- a numpy f32 transliteration of ``ACHA::tri`` and ``ACHA::tangent``
  (csrc/phys_acha.cuh: cos and sin of m theta as the m-th power of
  (phi_x, phi_y)/r) against the plain tangent in f32;
- the plain versions of the gather J.v and of kernel W at "acha" against
  ``make_pallas_jvp`` of the JAX package's anisotropic terms in interpret
  mode at 16^2, ffc3 and dunavant2, both forms; the isotropic J.v lies
  percents away, so the comparison tells the two apart;
- the port's block planes for ``anisotropy=True`` (kernel N's "ach"
  instantiation, ops/node_blocks.BUILT_AS) against the JAX package's
  ``make_block_jacobi`` of the anisotropic terms (f64, 1e-12), and the JAX
  package's anisotropic planes equal to its isotropic ones;
- the slice: both packages' anisotropic bench3 at 70^2 (hierarchy 70/35/7,
  the dense 7^2 coarse) for 3 adaptive steps, with the bounds of
  tests/test_torch_slice_bench3.py;
- the routing to the "acha" instantiations (W's box and counter, the
  chains' symbol and counters, N's symbol) and the refusals of the tile
  forms T10/T12/TS, the tiled configuration, kernel S and kernel Q.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders.
"""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import (Bench3Params,
                                                         make as make_torch,
                                                         make_aniso_terms)
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext, make_tangent_jvp
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               state_from_numpy, state_to_numpy,
                                               time_config_from_dict)
from pfhubbenchmarks_tpu_torch.ops import tri_box
from pfhubbenchmarks_tpu_torch.ops.gridjvp import make_gridjvp
from pfhubbenchmarks_tpu_torch.ops.node_blocks import NodeBlockPlan
from pfhubbenchmarks_tpu_torch.ops.shard_sweep import make_shard_sweep
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                        make_descend_chain)
from pfhubbenchmarks_tpu_torch.solve.gmg import build_hierarchy
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi_tangent

F32 = dict(rtol=2e-4, atol=2e-5)
F = 2
DT = 0.05
CSRC = Path(__file__).resolve().parent.parent / "pfhubbenchmarks_tpu_torch" / "csrc"


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair, dtype=torch.float32):
    return state_from_numpy(pair, "cpu", dtype)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _interface_state(pj, seed):
    """(w, w0) f64: the IC, and the IC with seeded noise on U and phi at the
    nodes where phi lies strictly between -1 and 1 (the interface); the
    bulk keeps phi = +-1 and U = Delta exactly, so its gradients are 0."""
    w0 = tuple(np.asarray(a, np.float64) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = []
    for a in w0:
        band = np.abs(a[1]) < 1.0
        noise = 0.05 * rng.standard_normal(a.shape) * band[None]
        w.append(a + noise)
    return tuple(w), w0


def _noisy_state(n, seed, dtype=np.float32):
    """(w, w0, v): the IC plus seeded noise, the IC, a seeded direction."""
    pj = make_jax(nx=n, ny=n)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = tuple(a + 0.05 * rng.standard_normal(a.shape) for a in w0)
    v = tuple(rng.standard_normal(a.shape) for a in w0)
    return tuple(tuple(a.astype(dtype) for a in p) for p in (w, w0, v))


def test_aniso_residual_and_observables_match_jax_f64():
    n, L = 24, 12.0
    pj = make_jax(nx=n, ny=n, Lx=L, Ly=L, anisotropy=True)
    pt = make_torch(nx=n, ny=n, Lx=L, Ly=L, anisotropy=True)
    w, w0 = _interface_state(pj, seed=11)
    band = np.abs(w0[0][1]) < 1.0
    assert band.any() and (~band).sum() > band.sum()   # bulk on both sides
    rj = pj.residual()(_j(w), _j(w0), DT)
    rt = pt.residual("cpu")(_t(w, torch.float64), _t(w0, torch.float64), DT)
    for a, b in zip(state_to_numpy(rt), rj):
        assert np.isfinite(a).all()
        assert _rel(a, np.asarray(b)) <= 1e-12
    obs_j = {k: float(f(_j(w))) for k, f in pj.observable_fns().items()}
    obs_t = {k: float(f(_t(w, torch.float64)))
             for k, f in pt.observable_fns("cpu").items()}
    assert obs_j.keys() == obs_t.keys()
    for k in obs_j:
        assert abs(obs_t[k] - obs_j[k]) <= 1e-12 * abs(obs_j[k]), k
    # the anisotropy is in the TFE: the isotropic one differs
    iso = float(make_torch(nx=n, ny=n, Lx=L, Ly=L).observable_fns("cpu")[
        "total_free_energy"](_t(w, torch.float64)))
    assert abs(iso - obs_t["total_free_energy"]) > 1e-9 * abs(iso)


def _ctx_pair(rng, shape, cut_rows):
    """Seeded (ctx, tctx) at quadrature points, f64; the gradient of phi is
    exactly 0 on the first ``cut_rows`` rows of every triangle (below the
    cut) and 1e-11 on the next (above it)."""

    def r(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    gshape = (4, 1) + shape[2:]
    u = (-0.3 + 0.1 * r(*shape), r(*shape))
    dphi = (r(*gshape), r(*gshape))
    for a in dphi:
        a[:, :, :cut_rows] = 0.0
        a[:, :, cut_rows] *= 1e-11
    du = ((r(*gshape), r(*gshape)), dphi)
    u0 = (-0.3 + 0.1 * r(*shape), r(*shape))
    du0 = tuple((r(*gshape), r(*gshape)) for _ in range(F))
    tu = tuple(r(*shape) for _ in range(F))
    tdu = tuple((r(*gshape), r(*gshape)) for _ in range(F))
    return (QPContext(u=u, du=du, u0=u0, du0=du0, dt=0.37),
            QPContext(u=tu, du=tdu, u0=None, du0=None, dt=None))


def test_aniso_tangent_matches_jvp():
    terms, terms_tangent = make_aniso_terms(Bench3Params())
    ctx, tctx = _ctx_pair(np.random.default_rng(3), (4, 3, 5, 6), cut_rows=1)

    def flat(u_, du_):
        s, f = terms(dataclasses.replace(ctx, u=u_, du=du_))
        return tuple(s) + tuple(x for fi in f for x in fi)

    _, ref = torch.func.jvp(flat, (ctx.u, ctx.du), (tctx.u, tctx.du))
    s, f = terms_tangent(ctx, tctx)
    got = tuple(s) + tuple(x for fi in f for x in fi)
    for a, b in zip(got, ref):
        a, b = torch.broadcast_tensors(a, b)
        assert torch.isfinite(b).all()
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)


def _acha_transliteration(p, ctx, tctx):
    """ACHA::tri and ACHA::tangent (csrc/phys_acha.cuh) in numpy f32,
    statement for statement, on the same context."""
    f = np.float32

    def a32(x):
        return np.asarray(x.numpy() if torch.is_tensor(x) else x, np.float32)

    D, W2, inv_tau0, lam = f(p.D), f(p.W0 ** 2), f(1.0 / p.tau0), f(p.lam)
    eps, fm = f(p.epsilon_m), f(p.m)
    c0, s0 = f(np.cos(p.m * p.theta0)), f(np.sin(p.m * p.theta0))
    phx, phy = (a32(x) for x in ctx.du[1])
    r2 = phx * phx + phy * phy
    safe = r2 > f(1e-20)
    r = np.sqrt(np.where(safe, r2, f(1)))
    c, s = np.where(safe, phx / r, f(1)), np.where(safe, phy / r, f(0))
    cm, sm = np.ones_like(c), np.zeros_like(c)
    for _ in range(p.m):
        cm, sm = cm * c - sm * s, sm * c + cm * s
    cp, sp = cm * c0 + sm * s0, sm * c0 - cm * s0
    a = f(1) + eps * cp
    beta = np.where(safe, (-eps * fm * sp) / a, f(0))
    dbeta = np.where(safe, (-eps * fm * fm * cp) / a - beta * beta, f(0))
    inv_tau = np.where(safe, inv_tau0 / (a * a), inv_tau0)
    tphx, tphy = np.where(safe, phx, f(1)), np.where(safe, phy, f(0))
    rinv2 = np.where(safe, f(1) / np.where(safe, r2, f(1)), f(1))
    kappa = W2 * inv_tau0
    U, phi = (a32(x) for x in ctx.u)
    d0, d1 = (a32(x) for x in tctx.u)
    (gx0, gy0), (gx1, gy1) = ((a32(x) for x in pair) for pair in tctx.du)
    p2 = phi * phi
    sv = f(1) - p2
    g = (phi - lam * U * sv) * sv
    dg = (-lam * sv * sv) * d0 + (f(1) - f(3) * p2 + f(4) * lam * U * phi * sv) * d1
    dth = (tphx * gy1 - tphy * gx1) * rinv2
    dgi = inv_tau * dg + g * (f(-2) * inv_tau * beta * dth)
    db = dbeta * dth
    Fx = kappa * (gx1 - beta * gy1 - db * tphy)
    Fy = kappa * (gy1 + beta * gx1 + db * tphx)
    dtf = f(ctx.dt)
    return ([d0 / dtf - f(0.5) * dgi, d1 / dtf - dgi],
            [(D * gx0 + f(0.5) * Fx, D * gy0 + f(0.5) * Fy), (Fx, Fy)])


def test_acha_cuda_tangent_transliterated_matches_plain():
    p = Bench3Params()
    _, terms_tangent = make_aniso_terms(p)
    ctx, tctx = _ctx_pair(np.random.default_rng(5), (4, 4, 6, 7), cut_rows=1)
    s_ref, f_ref = terms_tangent(ctx, tctx)
    s_got, f_got = _acha_transliteration(p, ctx, tctx)
    ref = [*s_ref, *(x for fi in f_ref for x in fi)]
    got = [*s_got, *(x for fi in f_got for x in fi)]
    for a, b in zip(got, ref):
        a, b = np.broadcast_arrays(a, b.numpy())
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)


@pytest.fixture(scope="module")
def jvp16():
    """(port problem, JAX problem, w, w0, v) at 16^2 on an 8 x 8 domain (the
    seed's interface crosses it), f32 numpy: the interface state of
    ``_interface_state`` and a seeded direction."""
    n, L = 16, 8.0
    pj = make_jax(nx=n, ny=n, Lx=L, Ly=L, anisotropy=True)
    pt = make_torch(nx=n, ny=n, Lx=L, Ly=L, anisotropy=True)
    w, w0 = _interface_state(pj, seed=2)
    rng = np.random.default_rng(12)
    v = tuple(rng.standard_normal(a.shape) for a in w0)
    return (pt, pj) + tuple(tuple(a.astype(np.float32) for a in p)
                            for p in (w, w0, v))


@pytest.mark.parametrize("rule", ["ffc3", "dunavant2"])
def test_acha_plain_matches_pallas_jvp(jvp16, rule):
    pt, pj, w, w0, v = jvp16
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    rv, rm = make_pallas_jvp(gj, pj.terms, F)(_j(w), _j(w0), DT, _j(v),
                                              interpret=True)
    ref = (np.asarray(rv), np.asarray(rm))
    assert all(np.isfinite(a).all() for a in ref)
    forms = ["gather"] + (["box"] if rule == "ffc3" else [])
    for form in forms:
        jv = pt.kernel_jvp(gt, "cpu", form=form)
        out = jv(_t(w), _t(w0), DT, _t(v))
        for a, b in zip(state_to_numpy(out), ref):
            np.testing.assert_allclose(a, b, **F32)
        res = jv(_t(w), _t(w0), DT, _t(v), b=_t(w0))   # the form b - J v
        for a, b, c in zip(state_to_numpy(res), w0, ref):
            np.testing.assert_allclose(a, b - c, **F32)
    # the isotropic J.v is percents away from the anisotropic one
    iso = make_torch(nx=16, ny=16, Lx=8.0, Ly=8.0).kernel_jvp(gt, "cpu")(
        _t(w), _t(w0), DT, _t(v))
    scale = max(float(np.abs(a).max()) for a in ref)
    dist = max(float(np.abs(a - b).max())
               for a, b in zip(state_to_numpy(iso), ref))
    assert dist > 0.01 * scale


def test_acha_plain_on_a_noisy_state_is_as_accurate_as_pallas():
    """Where the state's gradient is noise (the IC plus 0.05 noise at 16^2:
    triangles with |grad phi| down to 2e-4 against a typical 1e-3), the f32
    J.v loses digits to the 1/r of d theta: at dunavant2 one centre node of
    the m plane, 3.1832 by the f64 J.v among values up to 5.6e4, comes out
    3.2003 from the Pallas kernel and 3.1864 from the plain version, whose
    state gradient comes from the slots' differences to the centre, as the
    kernels form it (largest errors 0.458 and 0.0095). Both f32 J.v are held
    to the f64 one (the hand-written tangent, which ``torch.func.jvp`` holds
    at 1e-12): the plain version's largest error is at most 1.5 times the
    Pallas kernel's, and the two agree within rtol 2e-4, atol 2e-5 max|J.v|
    (chip_smoke.py's TOL_F32)."""
    n = 16
    pj = make_jax(nx=n, ny=n, anisotropy=True)
    pt = make_torch(nx=n, ny=n, anisotropy=True)
    w, w0, v = _noisy_state(n, seed=2)
    gj = dataclasses.replace(pj.grid, rule_name="dunavant2")
    gt = dataclasses.replace(pt.grid, rule_name="dunavant2")
    pal = [np.asarray(a) for a in make_pallas_jvp(gj, pj.terms, F)(
        _j(w), _j(w0), DT, _j(v), interpret=True)]
    got = state_to_numpy(pt.kernel_jvp(gt, "cpu")(_t(w), _t(w0), DT, _t(v)))
    jv64 = make_tangent_jvp(gt, pt.kernel_phys().tangent, device="cpu",
                            dtype=torch.float64)
    r64 = state_to_numpy(jv64(*(_t(p, torch.float64) for p in (w, w0)), DT,
                              _t(v, torch.float64)))
    scale = max(float(np.abs(a).max()) for a in r64)
    err_got = max(float(np.abs(a - r).max()) for a, r in zip(got, r64))
    err_pal = max(float(np.abs(a - r).max()) for a, r in zip(pal, r64))
    assert err_got <= 1.5 * err_pal and err_pal <= 1e-5 * scale
    for a, b in zip(got, pal):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale)


@pytest.fixture(scope="module")
def blocks16():
    """The JAX package's anisotropic and isotropic block planes (f64) at
    every level of bench3's hierarchy at 16^2, and the inputs."""
    n = 16
    pj = make_jax(nx=n, ny=n, anisotropy=True)
    pji = make_jax(nx=n, ny=n)
    pt = make_torch(nx=n, ny=n, anisotropy=True)
    rule = pt.solver.precond_rule
    gts = [dataclasses.replace(g, rule_name=rule)
           for g in build_hierarchy(pt.grid, min_cells=4)]
    rng = np.random.default_rng(7)
    levels = []
    for gt in gts:
        w0 = tuple(np.asarray(a, np.float64) for a in gt.interpolate(pt.ic_fns))
        w = tuple(a + 0.01 * rng.standard_normal(a.shape) for a in w0)
        levels.append((gt, w, w0))

    def planes(terms):
        builds = [jax_bj(dataclasses.replace(pj.grid, nx=gt.nx, ny=gt.ny,
                                             rule_name=rule), terms, F,
                         dtype=jnp.float64) for gt, _, _ in levels]
        return jax.jit(lambda st: [b(w_, w0_, DT).pinv_planes
                                   for b, (w_, w0_) in zip(builds, st)])(
            [(_j(w), _j(w0)) for _, w, w0 in levels])

    return pt, levels, planes(pj.terms), planes(pji.terms)


def test_aniso_block_planes_are_the_isotropic_kernel_n(blocks16):
    pt, levels, ref_aniso, ref_iso = blocks16
    for (gt, w, w0), ra, ri in zip(levels, ref_aniso, ref_iso):
        for a, b in zip(ra, ri):   # the JAX package's own two builds
            assert bool(jnp.array_equal(a, b))
        jv = pt.kernel_jvp(gt, "cpu")
        plan = NodeBlockPlan(gt, jv, pt.terms, device="cpu")
        assert plan._symbol == "pfh_node_blocks_ach"
        got = make_block_jacobi_tangent(
            gt, jv.tangent, F, device="cpu", dtype=torch.float64)(
                _t(w, torch.float64), _t(w0, torch.float64), DT).pinv_planes
        for a, b in zip(got, ra):
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-12, gt.nx
        p32 = plan(_t(w), _t(w0), DT)
        for a, b in zip(p32, ra):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def _record_norms(runner):
    """Wrap ``runner.step`` (either package's Runner) so that each call
    appends the residual norms of its Newton iterations; returns the list."""
    inner, hists = runner.step, []

    def step(*args):
        res, out = inner(*args)
        hists.append([float(h) for h in np.asarray(res.norm_hist)
                      if np.isfinite(h)])
        return res, out

    runner.step = step
    return hists


def test_bench3_aniso_slice_matches_jax_timeloop():
    """Both packages' anisotropic bench3 at 70^2 for 3 adaptive steps. The
    time grid, TFE (rel 1e-10) and solid fraction (rel 1e-9) as in
    tests/test_torch_slice_bench3.py, Krylov counts within +-1. Newton
    counts are equal, except at a knife edge: at step 1 the JAX package's
    second iterate has ||F|| = 1.5447e-6 against the stopping threshold
    newton_rtol ||F_0|| = 1.5012e-6 (2.9 % above it) and takes a third,
    where the port's is 7.385e-7. At the first iterate the two f32 J.v
    differ by up to 2.3e-3 of their largest entry, at 37 nodes, each in one
    of the 31 cells with a triangle whose f32 gradient of phi is rounding
    noise (1e-20 < |grad phi|^2 < 1e-12, above the cut): theta, and with it
    the rotation flux, comes from the rounding of each package's own sums
    there (the JAX package's run with its FGMRES in f64 keeps its count). A
    step whose counts differ must be such an edge: the same ||F_0|| (rel 1e-9) and
    first iterate (rel 1e-2), counts one apart, and at the smaller count
    the run that went on within 5 % above the threshold while the other is
    under it."""
    pj = make_jax(nx=70, ny=70, anisotropy=True)
    jr = jax_timeloop.Runner(pj)
    jh = _record_norms(jr)
    ref = jax_timeloop.run(pj, max_steps=3, verbose=False, _runner=jr)

    pt = make_torch(nx=70, ny=70, anisotropy=True,
                    solver=solver_config_from_dict(dataclasses.asdict(pj.solver)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [70, 35, 7] and build.dense_coarse
    tr_ = timeloop.Runner(pt, "cpu")
    th = _record_norms(tr_)
    got = timeloop.run(pt, device="cpu", max_steps=3, verbose=False,
                       _runner=tr_)

    assert got.columns == ref.columns
    np.testing.assert_array_equal(got.rows[:, 0], ref.rows[:, 0])
    tfe_rel = np.abs(got.rows[:, 1] - ref.rows[:, 1]) / np.abs(ref.rows[:, 1])
    sf_rel = np.abs(got.rows[:, 2] - ref.rows[:, 2]) / np.abs(ref.rows[:, 2])
    assert tfe_rel.max() <= 1e-10
    assert sf_rel.max() <= 1e-9
    for a, b in zip(got.stats, ref.stats):
        assert abs(a.krylov_iters - int(b.krylov_iters)) <= 1
    # one attempt per step on both sides, so the norms line up with the steps
    assert len(jh) == len(th) == 3
    s = pt.solver
    n_port = [st.newton_iters for st in got.stats]
    n_jax = [int(st.newton_iters) for st in ref.stats]
    for hp, hj, a, b in zip(th, jh, n_port, n_jax):
        assert abs(hp[0] - hj[0]) <= 1e-9 * hj[0]
        if a == b:
            continue
        thr = max(s.newton_atol, s.newton_rtol * hj[0])
        k = min(a, b)
        on, off = (hj, hp) if b > a else (hp, hj)
        assert abs(a - b) == 1
        assert abs(hp[1] - hj[1]) <= 1e-2 * hj[1]
        assert thr < on[k] <= 1.05 * thr and off[k] < thr
    assert n_jax == [3, 3, 3] and n_port == [2, 3, 3]


def test_acha_routes_to_its_own_instantiations():
    # W's box is ach's, read from its source
    m = re.search(r"using AchaBox = pfh::TriBox<(\d+), (\d+), \d+, \d+>;",
                  (CSRC / "acha_box.cu").read_text())
    assert tri_box.TRI_BOX["acha"] == (int(m.group(1)), int(m.group(2)))
    pt = make_torch(nx=70, ny=70, anisotropy=True)
    assert pt.outer_jvp_form == "box" and pt.kernel_phys().kind == "acha"
    assert len(pt.kernel_phys().constants) == 8
    jv = pt.kernel_jvp(pt.grid, "cpu", form="box")
    assert jv.plan.symbol == "pfh_acha_box" and jv.plan.name == "tri_box_acha"
    assert jv.gather.launch.kind == "acha"
    assert jv.gather.launch.head.size == make_torch(
        nx=70, ny=70).kernel_jvp(pt.grid, "cpu").launch.head.size
    grids = [dataclasses.replace(g, rule_name="dunavant2")
             for g in build_hierarchy(pt.grid)]
    jvs = [pt.kernel_jvp(g, "cpu") for g in grids]
    d = make_descend_chain(grids, jvs, nu=3, nu_fine=1)
    a = make_ascend_chain(grids, jvs, nu=3, nu_fine=1)
    assert d.plan.symbol == a.plan.symbol == "pfh_vcycle_chain_acha"
    assert d.plan.kernel_name == "vcycle_descend_chain_acha"
    assert a.plan.kernel_name == "vcycle_ascend_chain_acha"
    # the isotropic BM3 keeps its counters
    iso = make_torch(nx=70, ny=70)
    assert iso.kernel_jvp(iso.grid, "cpu", form="box").plan.name == "tri_box"


def test_acha_refuses_what_is_not_ported():
    pt = make_torch(nx=70, ny=70, anisotropy=True)
    for form in ("recompute", "seam"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            pt.kernel_jvp(pt.grid, "cpu", form=form)
    # the tiled configuration: T10 on the outer J.v, T12 and TS on the levels
    tiled = dataclasses.replace(pt, solver=dataclasses.replace(
        pt.solver, use_tiled_sweeps=True, tiled_grid_kernels=True))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tiled.lowp_jvp_factory("cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tiled.precond_builder("cpu")
    phys = pt.kernel_phys()
    slab = dataclasses.replace(pt.grid, nx=10, ny=10, Lx=10 * pt.grid.hx,
                               Ly=10 * pt.grid.hy)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_shard_sweep(slab, phys, F, device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_gridjvp(pt.grid, phys, device="cpu", br=10)
