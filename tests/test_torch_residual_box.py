"""The residual box (``csrc/fem_tri_box.cuh`` ``residual_box_kernel``,
``ops/residual_box.py``: kernel R's f32 residual over triangle boxes) on
the CPU, where it cannot run:

- the box constants of its launchers (``RESIDUAL_BOX``) are the C++ ones
  (``ChacRBox`` in csrc/chac_rbox.cu, ``ChpRBox`` in csrc/chp_rbox.cu);
- the plan at 100^2, 50^2, 25^2, 37 x 23 and 7^2 cells: every vertex and
  every centre is owned exactly once, and every owned node's cells lie in
  its box's evaluated cells;
- the plan's refusals (a physics with no instantiation, BM1's; a rule of
  other than 4 points), its box grid and its Dirichlet planes;
- a numpy f32 transliteration of the residual box's phases (stage the w
  and w0 planes of the box, evaluate each (cell, triangle, point)'s slot
  terms once through ``Phys::residual``, sum each owned node's terms in
  ``fem_residual_kernel``'s order, the Dirichlet rows w - g) equals, bit
  for bit, a transliteration of ``fem_residual_kernel`` (per node: cells
  SW, SE, NE, NW, triangles holding the slot ascending, points in order)
  with the same term arithmetic, at BM2 with 1, 2 and 4 order parameters
  (8^2, and 4 also 9 x 13) and BM6 with its Dirichlet rows (8^2, 16^2); and
  it is the residual: within kernel R's tolerance (rtol 1e-5, atol 1e-5
  max|R|, tests/test_torch_residual_kernel.py) of the plain version;
- the plain version against the JAX package's ``make_pallas_residual`` in
  interpret mode (as tests/test_pallas.py runs it) at bench2 8^2 with one
  order parameter and bench6 8^2 (its Dirichlet rows u - g applied after
  the kernel, as the JAX package's caller does), on the IC plus seeded
  noise against the IC: rtol 1e-5, atol 1e-5 max|R|, the tolerance of
  tests/test_torch_residual_kernel.py for such states;
- the routing: ``residual_lowp`` of bench2, bench2_eta1 and bench6 takes
  the residual box (``residual_form="box"``), bench1's stays kernel R;
  a direct launch with CPU tensors raises.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax6
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_residual
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench6
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import residual_box, tri_box
from pfhubbenchmarks_tpu_torch.ops.fem_residual import dirichlet_planes
from tests.test_torch_tri_box import SLOT_CELL, TRI_SLOTS, _f, _params, _slots

TOL_R = dict(rtol=1e-5, atol_scale=1e-5)   # tests/test_torch_residual_kernel.py
CSRC = Path(residual_box.__file__).resolve().parent.parent / "csrc"
PLAN_DIMS = [(100, 100), (50, 50), (25, 25), (37, 23), (7, 7)]   # (ny, nx)


def _problem(kind, ny, nx, ne=4):
    return (bench2.make(nx=nx, ny=ny, num_eta=ne) if kind == "chac"
            else bench6.make(nx=nx, ny=ny))


def _states(pb, seed):
    """(w, w0): the IC plus seeded noise, with the Dirichlet values on
    their rows, and the IC; f32 numpy pairs."""
    rng = np.random.default_rng(seed)
    w0 = tuple(state_to_numpy(tuple(t.float() for t in pb.initial_state("cpu"))))
    w = [(a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
         for a in w0]
    for bc in pb.dirichlet:
        w[0] = bc.apply_value(torch.tensor(w[0])).numpy()
    return tuple(w), w0


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def test_box_constants_are_the_kernels():
    for kind, src, alias in (("chac", "chac_rbox.cu", "ChacRBox"),
                             ("chp", "chp_rbox.cu", "ChpRBox")):
        m = re.search(rf"using {alias} = pfh::TriBox<(\d+), (\d+), \d+, \d+>;",
                      (CSRC / src).read_text())
        assert residual_box.RESIDUAL_BOX[kind] == (int(m.group(1)),
                                                   int(m.group(2)))
    # the launcher's box count is W's (fem_tri_box.cuh tri_boxes)
    assert "<<<tri_boxes<Box>(ny, nx), Box::kThreads, bytes," in (
        CSRC / "fem_tri_box.cuh").read_text().split("launch_residual_box")[1]


@pytest.mark.parametrize("kind", ["chac", "chp"])
@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_plan_owns_each_node_once_and_holds_its_cells(kind, dims):
    ny, nx = dims
    shape = residual_box.RESIDUAL_BOX[kind]
    nby, nbx = tri_box.grid_boxes(shape, ny, nx)
    owned_v = np.zeros((ny + 1, nx + 1), int)
    owned_m = np.zeros((ny, nx), int)
    for iy in range(nby):
        for ix in range(nbx):
            (vy, cy, ey), (vx, cx, ex) = tri_box.grid_box_ranges(
                shape, ny, nx, (iy, ix))
            owned_v[vy.start:vy.stop, vx.start:vx.stop] += 1
            owned_m[cy.start:cy.stop, cx.start:cx.stop] += 1
            for rng_v, rng_e, n in ((vy, ey, ny), (vx, ex, nx)):
                need = range(max(rng_v.start - 1, 0), min(rng_v.stop, n))
                assert not len(need) or (need.start >= rng_e.start
                                         and need.stop <= rng_e.stop)
            for rng_c, rng_e in ((cy, ey), (cx, ex)):
                assert not len(rng_c) or (rng_c.start >= rng_e.start
                                          and rng_c.stop <= rng_e.stop)
    assert (owned_v == 1).all() and (owned_m == 1).all()


def test_plan_fixes_its_launch_and_refuses():
    pb = bench6.make(nx=16, ny=12)
    res = pb.kernel_residual(pb.grid, "cpu", pb.dirichlet, form="box")
    plan = res.plan
    assert plan.symbol == "pfh_chp_rbox" and plan.variant == ()
    assert plan.boxes == tri_box.grid_boxes(residual_box.RESIDUAL_BOX["chp"],
                                            12, 16)
    mask, g = dirichlet_planes(pb.grid, pb.dirichlet, 3)
    assert np.array_equal(plan.planes[0].numpy(), mask)
    assert np.array_equal(plan.planes[1].numpy(), g)
    assert np.array_equal(plan.params[:-1], res.gather.launch.head)
    p2 = bench2.make(nx=8, ny=8, num_eta=2)
    plan2 = p2.kernel_residual(p2.grid, "cpu", form="box").plan
    assert plan2.symbol == "pfh_chac_rbox" and plan2.variant == (2,)
    assert plan2.planes == (None, None)
    p1 = bench1.make(nx=8, ny=8)
    with pytest.raises(NotImplementedError, match="no instantiation"):
        p1.kernel_residual(p1.grid, "cpu", form="box")
    g3 = dataclasses.replace(p2.grid, rule_name="dunavant2")
    with pytest.raises(NotImplementedError, match="4-point"):
        p2.kernel_residual(g3, "cpu", form="box")
    w = _t(_states(p2, 0)[0])
    with pytest.raises(ValueError, match="CUDA"):
        plan2(w, w, 0.1)


# ---- numpy transliterations --------------------------------------------------

def _h5(e):
    return e * e * e * (_f(6) * e * e - _f(15) * e + _f(10))


def _dh(e):
    return (_f(3) * e * e * (_f(6) * e * e - _f(15) * e + _f(10))
            + e * e * e * (_f(12) * e - _f(15)))


def _residual_chac(k, dt, u, gx, gy, u0):
    """phys_chac.cuh's CHAC<NE>::residual, elementwise in f32."""
    rho2, ca, cb, kc, ke, M, w, alpha, L = k[:9]
    ne = len(u) - 2
    c = u[0]
    H = _f(0)
    for i in range(ne):
        H = H + _h5(u[2 + i])
    src = [(c - u0[0]) / dt,
           u[1] - _f(2) * rho2 * ((c - ca) * (_f(1) - H) + (c - cb) * H)]
    fx, fy = [M * gx[1], -kc * gx[0]], [M * gy[1], -kc * gy[0]]
    fba = rho2 * (c - cb) * (c - cb) - rho2 * (c - ca) * (c - ca)
    for i in range(ne):
        e = u[2 + i]
        osq = _f(0)
        for j in range(ne):
            if j != i:
                osq = osq + u[2 + j] * u[2 + j]
        dwell = _f(2) * e * (_f(1) - e) * (_f(1) - _f(2) * e)
        dfde = fba * _dh(e) + w * (dwell + _f(2) * alpha * e * osq)
        src.append((e - u0[2 + i]) / dt + L * dfde)
        fx.append(L * ke * gx[2 + i])
        fy.append(L * ke * gy[2 + i])
    return src, fx, fy


def _residual_chp(k, dt, u, gx, gy, u0):
    """phys_chp.cuh's CHP::residual, elementwise in f32."""
    M, kappa, rho, ca, cb, kk, eps = k[:7]
    c = u[0]
    a = c - ca
    b = cb - c
    src = [(c - u0[0]) / dt,
           u[1] - (_f(2) * rho * a * b * (b - a) + kk * u[2]), kk * c / eps]
    return (src, [M * gx[1], -kappa * gx[0], -gx[2]],
            [M * gy[1], -kappa * gy[0], -gy[2]])


class _Phys:
    """One physics' residual as the kernels see it."""

    def __init__(self, kind, res):
        self.F = res.gather.launch.n_fields
        self.P = _params(res.plan.params[:-1])
        self.residual = _residual_chac if kind == "chac" else _residual_chp

    def terms(self, dt, wc, w0c, t, nq):
        """cell_residual's terms of triangle t, elementwise over cells: ``wc``
        and ``w0c`` [F][5] slot values -> [q][3][f], the triangle's slots in
        TRI_SLOTS order; products and sums each rounded in f32."""
        P, F = self.P, self.F
        gx, gy = [_f(0)] * F, [_f(0)] * F
        for s in range(5):
            for f in range(F):
                gx[f] = gx[f] + P["Gs"][t, s, 0] * wc[f][s]
                gy[f] = gy[f] + P["Gs"][t, s, 1] * wc[f][s]
        out = []
        for q in range(nq):
            u, u0 = [_f(0)] * F, [_f(0)] * F
            for s in range(5):
                for f in range(F):
                    u[f] = u[f] + P["Bq"][t, q, s] * wc[f][s]
                    u0[f] = u0[f] + P["Bq"][t, q, s] * w0c[f][s]
            src, fx, fy = self.residual(P["k"], dt, u, gx, gy, u0)
            out.append([[P["WB"][t, q, S] * src[f] + P["WGx"][t, q, S] * fx[f]
                         + P["WGy"][t, q, S] * fy[f] for f in range(F)]
                        for S in TRI_SLOTS[t]])
        return out


def _dirichlet_rows(out_v, w, planes):
    mask, g = planes
    if mask is None:
        return out_v
    return np.where(mask != 0, w[0] - g, out_v)


def gather_residual(ph, w, w0, dt, nq, planes):
    """fem_residual_kernel: each node's terms added from 0, cells SW, SE,
    NE, NW (the vertex as slot 0..3), triangles holding the slot ascending,
    points in order; a centre its cell's four triangles; then the Dirichlet
    rows w - g."""
    F = ph.F
    wc = [_slots(w[0][f], w[1][f]) for f in range(F)]
    w0c = [_slots(w0[0][f], w0[1][f]) for f in range(F)]
    T = [ph.terms(dt, wc, w0c, t, nq) for t in range(4)]
    ny, nx = w[1].shape[1:]
    acc_v = np.zeros(w[0].shape, np.float32)
    acc_m = np.zeros(w[1].shape, np.float32)
    views = (np.s_[:ny, :nx], np.s_[:ny, 1:], np.s_[1:, 1:], np.s_[1:, :nx])
    for S in range(4):
        for t in range(4):
            if S not in TRI_SLOTS[t]:
                continue
            j = TRI_SLOTS[t].index(S)
            for q in range(nq):
                for f in range(F):
                    acc_v[f][views[S]] += T[t][q][j][f]
    for t in range(4):
        for q in range(nq):
            for f in range(F):
                acc_m[f] += T[t][q][2][f]
    return _dirichlet_rows(acc_v, w, planes), acc_m


def box_residual(ph, w, w0, dt, nq, kind, planes):
    """The residual box through the plan's geometry: per box, stage the w
    and w0 planes of the local frame (NaN where nothing is staged), evaluate
    the box's cells into local terms (NaN elsewhere), sum each owned node's
    local terms in fem_residual_kernel's order; then the Dirichlet rows."""
    F = ph.F
    ny, nx = w[1].shape[1:]
    shape = residual_box.RESIDUAL_BOX[kind]
    by, bx = shape
    kcy, kcx = by + 1, bx + 1
    out_v = np.full(w[0].shape, np.nan, np.float32)
    out_m = np.full(w[1].shape, np.nan, np.float32)
    nby, nbx = tri_box.grid_boxes(shape, ny, nx)
    for iy in range(nby):
        for ix in range(nbx):
            (vy, cy, ey), (vx, cx, ex) = tri_box.grid_box_ranges(
                shape, ny, nx, (iy, ix))
            oy, ox = iy * by - 1, ix * bx - 1    # local 0 is global o - 1

            def stage(plane, nrow, ncol, r, c):
                loc = np.full((nrow, ncol), np.nan, np.float32)
                r0, c0 = max(oy, 0), max(ox, 0)
                r1, c1 = min(oy + nrow, r), min(ox + ncol, c)
                loc[r0 - oy:r1 - oy, c0 - ox:c1 - ox] = plane[r0:r1, c0:c1]
                return loc

            def staged(pair):
                return [_slots(stage(pair[0][f], kcy + 1, kcx + 1, ny + 1,
                                     nx + 1),
                               stage(pair[1][f], kcy, kcx, ny, nx))
                        for f in range(F)]

            evaluated = np.zeros((kcy, kcx), bool)
            evaluated[ey.start - oy:ey.stop - oy, ex.start - ox:ex.stop - ox] = True
            T = [[[[np.where(evaluated, x, np.float32(np.nan)) for x in xs]
                   for xs in q_terms]
                  for q_terms in ph.terms(dt, staged(w), staged(w0), t, nq)]
                 for t in range(4)]
            for y in vy:
                for x in vx:
                    acc = np.zeros(F, np.float32)
                    for S, (dy, dx) in enumerate(SLOT_CELL):
                        gy_, gx_ = y + dy, x + dx
                        if not (0 <= gy_ < ny and 0 <= gx_ < nx):
                            continue
                        for t in range(4):
                            if S not in TRI_SLOTS[t]:
                                continue
                            j = TRI_SLOTS[t].index(S)
                            for q in range(nq):
                                for f in range(F):
                                    acc[f] += T[t][q][j][f][gy_ - oy, gx_ - ox]
                    out_v[:, y, x] = acc
            for y in cy:
                for x in cx:
                    acc = np.zeros(F, np.float32)
                    for t in range(4):
                        for q in range(nq):
                            for f in range(F):
                                acc[f] += T[t][q][2][f][y - oy, x - ox]
                    out_m[:, y, x] = acc
    return _dirichlet_rows(out_v, w, planes), out_m


@pytest.mark.parametrize("kind, ne, dims", [
    ("chac", 1, (8, 8)), ("chac", 2, (8, 8)), ("chac", 4, (8, 8)),
    ("chac", 4, (9, 13)), ("chp", None, (8, 8)), ("chp", None, (16, 16))])
def test_box_transliteration_is_r_bit_for_bit(kind, ne, dims):
    pb = _problem(kind, *dims, ne or 4)
    g = pb.grid
    assert g.rule_name == "ffc3" and pb.residual_form == "box"
    res = pb.kernel_residual(g, "cpu", pb.dirichlet, form="box")
    ph = _Phys(kind, res)
    planes = dirichlet_planes(g, pb.dirichlet, ph.F)
    assert (planes[0] is not None) == (kind == "chp")
    w, w0 = _states(pb, seed=sum(dims) + (ne or 0))
    dt = _f(0.16 if kind == "chac" else 0.32)
    nq = g.tab().nq
    ref = gather_residual(ph, w, w0, dt, nq, planes)
    got = box_residual(ph, w, w0, dt, nq, kind, planes)
    for a, b in zip(got, ref):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b)
    # and it is the residual: the plain version, at kernel R's tolerance
    plain = state_to_numpy(res.plain(_t(w), _t(w0), float(dt)))
    scale = max(float(np.abs(b).max()) for b in plain)
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a, b, rtol=TOL_R["rtol"],
                                   atol=TOL_R["atol_scale"] * scale)


@pytest.mark.parametrize("name", ["bench2", "bench6"])
def test_plain_matches_make_pallas_residual(name):
    n, dt = 8, (0.16 if name == "bench2" else 0.32)
    pt = _problem("chac" if name == "bench2" else "chp", n, n, ne=1)
    pj = (make_jax2(nx=n, ny=n, num_eta=1) if name == "bench2"
          else make_jax6(nx=n, ny=n))
    w, w0 = _states(pt, seed=7)
    jw = tuple(map(jnp.asarray, w))
    rv, rm = make_pallas_residual(pj.grid, pj.terms, pt.n_fields)(
        jw, tuple(map(jnp.asarray, w0)), dt, interpret=True)
    for bc in pj.dirichlet:   # the caller's rows u - g
        rv = bc.apply_residual(rv, jw[0])
    res = pt.residual_lowp("cpu")
    got = state_to_numpy(res(_t(w), _t(w0), dt))
    want = (np.asarray(rv), np.asarray(rm))
    scale = max(float(np.abs(b).max()) for b in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=TOL_R["rtol"],
                                   atol=TOL_R["atol_scale"] * scale)


def test_residual_lowp_takes_the_box():
    for make in (bench2.make, lambda **kw: bench2.make(num_eta=1, **kw),
                 bench6.make):
        p = make(nx=8, ny=8)
        res = p.residual_lowp("cpu")
        assert isinstance(res.plan, residual_box.ResidualBoxPlan)
        assert res.plain is res.gather.plain
        w = tuple(t.float() for t in p.initial_state("cpu"))
        for a, b in zip(res(w, w, 0.1), res.gather.plain(w, w, 0.1)):
            assert torch.equal(a, b)
    p1 = bench1.make(nx=8, ny=8)
    assert p1.residual_form == "gather"
    assert not hasattr(p1.residual_lowp("cpu"), "plan")
