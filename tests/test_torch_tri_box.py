"""Kernel W (``csrc/fem_tri_box.cuh``, the crossed-P1 J.v over triangle
boxes) on the CPU, where it cannot run:

- the box constants of its launcher (``ops/tri_box.TRI_BOX``) are the C++
  ones (``ChBox`` in csrc/ch_box.cu, ``ChacBox`` in csrc/chac_box.cu,
  ``AchBox`` in csrc/ach_box.cu, ``ChpBox`` in csrc/chp_box.cu);
- the box plan at 100^2, 350^2, 175^2, 50^2, 35^2, 25^2, 7^2 and 13 x 21
  cells, for every box: every vertex and every centre is owned exactly
  once, and every owned node's cells lie in its box's evaluated cells,
  which lie in the kernel's local frame of (BY + 1) x (BX + 1) cells;
- a numpy f32 transliteration of W's phases (stage the box, evaluate each
  (cell, triangle, point)'s slot terms once, sum each owned node's terms in
  jvp_node's order, all through the plan's indices) equals, bit for bit, a
  numpy transliteration of the gather's per-node loop (jvp_node: cells SW,
  SE, NE, NW, triangles ascending, points in order) with the same term
  arithmetic, at 8^2 and 16^2 for BM1, BM2 (1, 2 and 4 order parameters,
  the coupled operator), BM3 and BM6 with its Dirichlet rows (both stores:
  a masked vertex row is the tangent value, jvp_store's), ffc3; and it is
  the J.v: within rtol 2e-4 / atol 2e-5 of the plain version;
- the ``form="box"`` wrappers on the CPU (the plain version) against the
  JAX package's ``make_pallas_jvp`` in interpret mode at the JAX kernel
  tests' rtol 2e-4 / atol 2e-5 (tests/test_pallas.py:36): BM1 at 8^2, BM2
  with one order parameter at 8^2, BM3 at 16^2 and BM6 at 8^2 with its
  Dirichlet rows (re-set to v after the Pallas kernel, as the JAX package's
  ``benchmarks/base.py:201-215`` does), J.v and b - J.v; a direct call of
  W with CPU tensors raises;
- the plan's refusals (the split operator, a rule of other than 4 points,
  Dirichlet rows at a physics whose box takes none, a physics with no
  instantiation);
- the routing: ``lowp_jvp_factory`` and the exported A z (``mv_jv``) of
  bench1, bench2 and bench3 ask for the box form (the tiled configuration:
  T10 for the outer J.v), and on the CPU give the plain version's values;
  bench6's outer J.v asks for the box form with its Dirichlet rows, and its
  levels stay on the gather (kernel E).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax1
from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax3
from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax6
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import tri_box
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import MAX_CONST, MAX_Q

F32 = dict(rtol=2e-4, atol=2e-5)
CSRC = Path(tri_box.__file__).resolve().parent.parent / "csrc"
PLAN_DIMS = [(100, 100), (350, 350), (175, 175), (50, 50), (35, 35),
             (25, 25), (7, 7), (13, 21)]   # (ny, nx) cells
# slots of each triangle (S, E, N, W; centre 4 in all), as fem_params.cuh
TRI_SLOTS = ((0, 1, 4), (1, 2, 4), (2, 3, 4), (0, 3, 4))
# the cell of a vertex at slot S: (dy, dx) from the vertex (jvp_node)
SLOT_CELL = ((0, 0), (0, -1), (-1, -1), (-1, 0))


def _f(x):
    return np.float32(x)


def _problem(kind, n, ne=4):
    if kind == "ch":
        return bench1.make(nx=n, ny=n)
    if kind == "chp":
        return bench6.make(nx=n, ny=n)
    return (bench2.make(nx=n, ny=n, num_eta=ne) if kind == "chac"
            else bench3.make(nx=n, ny=n))


def _inputs(pb, seed):
    """(w, v, b): the IC plus seeded noise, two random directions, f32
    numpy pairs."""
    rng = np.random.default_rng(seed)
    v0, m0 = pb.grid.interpolate(pb.ic_fns)
    w = tuple((a + 0.01 * rng.standard_normal(a.shape)).astype(np.float32)
              for a in (np.asarray(v0), np.asarray(m0)))
    v, b = (tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
            for _ in range(2))
    return w, v, b


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def test_box_constants_are_the_kernels():
    for kind, src, alias in (("ch", "ch_box.cu", "ChBox"),
                             ("chac", "chac_box.cu", "ChacBox"),
                             ("ach", "ach_box.cu", "AchBox"),
                             ("chp", "chp_box.cu", "ChpBox")):
        m = re.search(rf"using {alias} = pfh::TriBox<(\d+), (\d+), \d+, \d+>;",
                      (CSRC / src).read_text())
        assert tri_box.TRI_BOX[kind] == (int(m.group(1)), int(m.group(2)))
    # the launcher's box count, ceil((n + 1) / B) along each axis
    assert ("return ((ny + Box::BY) / Box::BY) * ((nx + Box::BX) / Box::BX);"
            in (CSRC / "fem_tri_box.cuh").read_text())


@pytest.mark.parametrize("kind", ["ch", "chac", "ach", "chp"])
@pytest.mark.parametrize("dims", PLAN_DIMS)
def test_box_plan_owns_each_node_once_and_holds_its_cells(kind, dims):
    ny, nx = dims
    by, bx = tri_box.TRI_BOX[kind]
    nby, nbx = tri_box.tri_boxes(kind, ny, nx)
    owned_v = np.zeros((ny + 1, nx + 1), int)
    owned_m = np.zeros((ny, nx), int)
    for iy in range(nby):
        for ix in range(nbx):
            (vy, cy, ey), (vx, cx, ex) = tri_box.box_ranges(kind, ny, nx,
                                                            (iy, ix))
            owned_v[vy.start:vy.stop, vx.start:vx.stop] += 1
            owned_m[cy.start:cy.stop, cx.start:cx.stop] += 1
            # the evaluated cells lie in the grid and in the kernel's local
            # frame: cells oy - 1 .. oy + BY (and x likewise)
            oy, ox = iy * by, ix * bx
            assert ey.start >= max(oy - 1, 0) and ey.stop <= min(oy + by, ny)
            assert ex.start >= max(ox - 1, 0) and ex.stop <= min(ox + bx, nx)
            # every owned vertex's cells, and every owned centre's cell
            for rng_v, rng_e, n in ((vy, ey, ny), (vx, ex, nx)):
                need = range(max(rng_v.start - 1, 0), min(rng_v.stop, n))
                assert not len(need) or (need.start >= rng_e.start
                                         and need.stop <= rng_e.stop)
            for rng_c, rng_e in ((cy, ey), (cx, ex)):
                assert not len(rng_c) or (rng_c.start >= rng_e.start
                                          and rng_c.stop <= rng_e.stop)
    assert (owned_v == 1).all() and (owned_m == 1).all()


# ---- numpy transliterations --------------------------------------------------

def _params(head):
    """The JvpParams block (csrc/fem_params.cuh) from a parameter head."""
    sizes = dict(Bq=(4, MAX_Q, 5), Gs=(4, 5, 2), WB=(4, MAX_Q, 5),
                 WGx=(4, MAX_Q, 5), WGy=(4, MAX_Q, 5))
    out, o = {}, 0
    for name, shape in sizes.items():
        n = int(np.prod(shape))
        out[name] = head[o:o + n].reshape(shape)
        o += n
    out["k"] = head[o:o + MAX_CONST]
    assert o + MAX_CONST == head.size
    return out


def _dh(e):
    return (_f(3) * e * e * (_f(6) * e * e - _f(15) * e + _f(10))
            + e * e * e * (_f(12) * e - _f(15)))


def _d2h(e):
    return (_f(6) * e * (_f(6) * e * e - _f(15) * e + _f(10))
            + _f(6) * e * e * (_f(12) * e - _f(15)) + _f(12) * e * e * e)


def _tangent_chac(k, dt, ne, u, d, gx, gy):
    """phys_chac.cuh's CHAC<NE, false>::tangent, elementwise in f32."""
    rho2, ca, cb, kc, ke, M, w, alpha, L = k[:9]
    c = u[0]
    src, fx, fy = [None] * (2 + ne), [None] * (2 + ne), [None] * (2 + ne)
    src[0] = d[0] / dt
    fx[0], fy[0] = M * gx[1], M * gy[1]
    fx[1], fy[1] = -kc * gx[0], -kc * gy[0]
    fba = rho2 * (c - cb) * (c - cb) - rho2 * (c - ca) * (c - ca)
    hd = _f(0)
    for i in range(ne):
        hd = hd + _dh(u[1 + i]) * d[2 + i]
    src[1] = d[1] - _f(2) * rho2 * (d[0] + (ca - cb) * hd)
    for i in range(ne):
        e, de = u[1 + i], d[2 + i]
        osq = oed = _f(0)
        for j in range(ne):
            if j != i:
                osq = osq + u[1 + j] * u[1 + j]
                oed = oed + u[1 + j] * d[2 + j]
        dwp = _f(2) - _f(12) * e + _f(12) * e * e
        diag = fba * _d2h(e) + w * (dwp + _f(2) * alpha * osq)
        rhs = (_f(2) * rho2 * (ca - cb) * _dh(e) * d[0] + diag * de
               + _f(4) * w * alpha * e * oed)
        src[2 + i] = de / dt + L * rhs
        fx[2 + i], fy[2 + i] = L * ke * gx[2 + i], L * ke * gy[2 + i]
    return src, fx, fy


def _tangent_ch(k, dt, u, d, gx, gy):
    """phys_ch.cuh's CH::tangent, elementwise in f32."""
    M, kappa, rho_s, ca, cb = k[:5]
    c = u[0]
    a = c - ca
    b = cb - c
    fpp = _f(2) * rho_s * ((b - a) * (b - a) - _f(2) * a * b)
    return ([d[0] / dt, d[1] - fpp * d[0]], [M * gx[1], -kappa * gx[0]],
            [M * gy[1], -kappa * gy[0]])


def _tangent_chp(k, dt, u, d, gx, gy):
    """phys_chp.cuh's CHP::tangent, elementwise in f32."""
    M, kappa, rho, ca, cb, kk, eps = k[:7]
    c = u[0]
    a = c - ca
    b = cb - c
    fpp = _f(2) * rho * ((b - a) * (b - a) - _f(2) * a * b)
    return ([d[0] / dt, d[1] - fpp * d[0] - kk * d[2], kk * d[0] / eps],
            [M * gx[1], -kappa * gx[0], -gx[2]],
            [M * gy[1], -kappa * gy[0], -gy[2]])


def _tangent_ach(k, dt, u, d, gx, gy):
    """phys_ach.cuh's ACH::tangent, elementwise in f32."""
    D, W2, inv_tau, lam = k[:4]
    U, phi = u
    p2 = phi * phi
    s = _f(1) - p2
    gU = -lam * s * s
    gp = _f(1) - _f(3) * p2 + _f(4) * lam * U * phi * s
    dg = gU * d[0] + gp * d[1]
    kw = inv_tau * W2
    src = [d[0] / dt - _f(0.5) * inv_tau * dg, d[1] / dt - inv_tau * dg]
    fx = [D * gx[0] + _f(0.5) * kw * gx[1], kw * gx[1]]
    fy = [D * gy[0] + _f(0.5) * kw * gy[1], kw * gy[1]]
    return src, fx, fy


class _Phys:
    """One physics as the kernels see it: the state fields the tangent reads
    and the tangent."""

    def __init__(self, kind, ne, jv):
        self.F = jv.n_fields
        self.state = {"ch": (0,), "chac": (0,) + tuple(range(2, 2 + (ne or 0))),
                      "ach": (0, 1), "chp": (0,)}[kind]
        self.P = _params(jv.plan.params[:-1])
        self.kind, self.ne = kind, ne

    def tangent(self, dt, u, d, gx, gy):
        k = self.P["k"]
        if self.kind == "chac":
            return _tangent_chac(k, dt, self.ne, u, d, gx, gy)
        if self.kind == "ch":
            return _tangent_ch(k, dt, u, d, gx, gy)
        if self.kind == "chp":
            return _tangent_chp(k, dt, u, d, gx, gy)
        return _tangent_ach(k, dt, u, d, gx, gy)

    def terms(self, dt, wc, d, t, nq):
        """slot_contrib's terms of triangle t, elementwise over cells: ``wc``
        [NS][5] and ``d`` [F][5] slot values -> [q][3][f], the triangle's
        slots in TRI_SLOTS order; products and sums each rounded in f32."""
        P, F = self.P, self.F
        gx, gy = [_f(0)] * F, [_f(0)] * F
        for s in range(5):
            for f in range(F):
                gx[f] = gx[f] + P["Gs"][t, s, 0] * d[f][s]
                gy[f] = gy[f] + P["Gs"][t, s, 1] * d[f][s]
        out = []
        for q in range(nq):
            u = [_f(0)] * len(wc)
            dq = [_f(0)] * F
            for s in range(5):
                for f in range(len(wc)):
                    u[f] = u[f] + P["Bq"][t, q, s] * wc[f][s]
                for f in range(F):
                    dq[f] = dq[f] + P["Bq"][t, q, s] * d[f][s]
            src, fx, fy = self.tangent(dt, u, dq, gx, gy)
            out.append([[P["WB"][t, q, S] * src[f] + P["WGx"][t, q, S] * fx[f]
                         + P["WGy"][t, q, S] * fy[f] for f in range(F)]
                        for S in TRI_SLOTS[t]])
        return out


def _slots(pv, pm):
    """The 5 slot planes (SW, SE, NE, NW, C) of every cell of (pv, pm)."""
    return (pv[:-1, :-1], pv[:-1, 1:], pv[1:, 1:], pv[1:, :-1], pm)


def gather_jvp(ph, w, v, dt, nq, mask=None):
    """jvp_node: each node's terms added from 0, cells SW, SE, NE, NW (the
    vertex as slot 0..3), triangles holding the slot ascending, points in
    order; a centre its cell's four triangles. Then jvp_store: a vertex row
    where ``mask`` is nonzero is the tangent value itself."""
    (wv, wm), (tv, tm) = w, v
    wc = [_slots(wv[f], wm[f]) for f in ph.state]
    d = [_slots(tv[f], tm[f]) for f in range(ph.F)]
    T = [ph.terms(dt, wc, d, t, nq) for t in range(4)]
    ny, nx = wm.shape[1:]
    acc_v = np.zeros(tv.shape, np.float32)
    acc_m = np.zeros(tm.shape, np.float32)
    views = (np.s_[:ny, :nx], np.s_[:ny, 1:], np.s_[1:, 1:], np.s_[1:, :nx])
    for S in range(4):
        for t in range(4):
            if S not in TRI_SLOTS[t]:
                continue
            j = TRI_SLOTS[t].index(S)
            for q in range(nq):
                for f in range(ph.F):
                    acc_v[f][views[S]] += T[t][q][j][f]
    for t in range(4):
        for q in range(nq):
            for f in range(ph.F):
                acc_m[f] += T[t][q][2][f]
    if mask is not None:
        acc_v = np.where(mask != 0, tv, acc_v)
    return acc_v, acc_m


def box_jvp(ph, w, v, dt, nq, kind, mask=None):
    """W through the plan: per box, stage the planes of the local frame
    (cells oy - 1 .. oy + BY, vertices one more; NaN where nothing is
    staged), evaluate the plan's cells into local terms (NaN elsewhere), then
    sum each owned node's local terms in jvp_node's order and store it, an
    owned vertex's masked row as the tangent value (the kMask store)."""
    (wv, wm), (tv, tm) = w, v
    F = ph.F
    ny, nx = wm.shape[1:]
    by, bx = tri_box.TRI_BOX[kind]
    kcy, kcx = by + 1, bx + 1
    out_v = np.full(tv.shape, np.nan, np.float32)
    out_m = np.full(tm.shape, np.nan, np.float32)
    nby, nbx = tri_box.tri_boxes(kind, ny, nx)
    for iy in range(nby):
        for ix in range(nbx):
            (vy, cy, ey), (vx, cx, ex) = tri_box.box_ranges(kind, ny, nx,
                                                            (iy, ix))
            oy, ox = iy * by - 1, ix * bx - 1    # local 0 is global o - 1

            def stage(plane, nrow, ncol, r, c):
                loc = np.full((nrow, ncol), np.nan, np.float32)
                r0, c0 = max(oy, 0), max(ox, 0)
                r1, c1 = min(oy + nrow, r), min(ox + ncol, c)
                loc[r0 - oy:r1 - oy, c0 - ox:c1 - ox] = plane[r0:r1, c0:c1]
                return loc

            sv = {f: stage(wv[f], kcy + 1, kcx + 1, ny + 1, nx + 1)
                  for f in ph.state}
            sm = {f: stage(wm[f], kcy, kcx, ny, nx) for f in ph.state}
            dv = [stage(tv[f], kcy + 1, kcx + 1, ny + 1, nx + 1)
                  for f in range(F)]
            dm = [stage(tm[f], kcy, kcx, ny, nx) for f in range(F)]
            wc = [_slots(sv[f], sm[f]) for f in ph.state]
            d = [_slots(dv[f], dm[f]) for f in range(F)]
            evaluated = np.zeros((kcy, kcx), bool)
            evaluated[ey.start - oy:ey.stop - oy, ex.start - ox:ex.stop - ox] = True
            T = [[[[np.where(evaluated, x, np.float32(np.nan)) for x in xs]
                   for xs in q_terms] for q_terms in ph.terms(dt, wc, d, t, nq)]
                 for t in range(4)]
            for y in vy:
                for x in vx:
                    acc = np.zeros(F, np.float32)
                    for S, (dy, dx) in enumerate(SLOT_CELL):
                        gy_, gx_ = y + dy, x + dx
                        if not (0 <= gy_ < ny and 0 <= gx_ < nx):
                            continue
                        ly, lx = gy_ - oy, gx_ - ox
                        for t in range(4):
                            if S not in TRI_SLOTS[t]:
                                continue
                            j = TRI_SLOTS[t].index(S)
                            for q in range(nq):
                                for f in range(F):
                                    acc[f] += T[t][q][j][f][ly, lx]
                    if mask is not None:
                        acc = np.where(mask[:, y, x] != 0, tv[:, y, x], acc)
                    out_v[:, y, x] = acc
            for y in cy:
                for x in cx:
                    acc = np.zeros(F, np.float32)
                    for t in range(4):
                        for q in range(nq):
                            for f in range(F):
                                acc[f] += T[t][q][2][f][y - oy, x - ox]
                    out_m[:, y, x] = acc
    return out_v, out_m


@pytest.mark.parametrize("kind, ne", [("ch", None), ("chac", 1), ("chac", 2),
                                      ("chac", 4), ("ach", None),
                                      ("chp", None)])
@pytest.mark.parametrize("n", [8, 16])
def test_box_transliteration_is_the_gather_bit_for_bit(kind, ne, n):
    pb = _problem(kind, n, ne or 4)
    g = pb.grid
    assert g.rule_name == "ffc3"
    jv = pb.kernel_jvp(g, "cpu", pb.dirichlet, form="box")
    ph = _Phys(kind, ne, jv)
    w, v, _ = _inputs(pb, seed=n + (ne or 0))
    if pb.dirichlet:
        wv = torch.as_tensor(w[0])
        for bc in pb.dirichlet:
            wv = bc.apply_value(wv)
        w = (wv.numpy(), w[1])
    mask = None if jv.plan.mask is None else jv.plan.mask.numpy()
    assert (mask is not None) == (kind == "chp")
    dt = _f({"ch": 0.5, "chac": 0.16, "ach": 1.28, "chp": 0.32}[kind])
    nq = g.tab().nq
    ref = gather_jvp(ph, w, v, dt, nq, mask)
    got = box_jvp(ph, w, v, dt, nq, kind, mask)
    for a, b in zip(got, ref):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b)
    # and it is the J.v: the plain version, at the f32 tolerance
    plain = state_to_numpy(jv.plain(_t(w), _t(w), float(dt), _t(v)))
    for a, b in zip(got, plain):
        np.testing.assert_allclose(a, b, rtol=F32["rtol"],
                                   atol=F32["atol"] * max(np.abs(b).max(), 1))


@pytest.mark.parametrize("kind, n", [("ch", 8), ("chac", 8), ("ach", 16),
                                     ("chp", 8)])
def test_box_wrapper_matches_pallas_jvp(kind, n):
    pt = _problem(kind, n, 1)
    pj = {"ch": lambda: make_jax1(nx=n, ny=n),
          "chac": lambda: make_jax2(nx=n, ny=n, num_eta=1),
          "ach": lambda: make_jax3(nx=n, ny=n),
          "chp": lambda: make_jax6(nx=n, ny=n)}[kind]()
    w, v, _ = _inputs(pt, seed=3)
    w0 = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    dt = 0.05
    ref = make_pallas_jvp(pj.grid, pj.terms, pt.n_fields)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)), dt,
        tuple(map(jnp.asarray, v)), interpret=True)
    # the Dirichlet rows the JAX package re-sets after its kernel
    # (benchmarks/base.py:201-215): v there
    ref = (np.asarray(ref[0]).copy(), np.asarray(ref[1]))
    for bc in pj.dirichlet:
        f, i = bc.field, bc.index
        rows = np.s_[f, :, i] if bc.side in ("left", "right") else np.s_[f, i, :]
        ref[0][rows] = v[0][rows]
    assert bool(pj.dirichlet) == (kind == "chp")
    jv = pt.kernel_jvp(pt.grid, "cpu", pt.dirichlet, form="box")
    for a, b in zip(state_to_numpy(jv(_t(w), _t(w0), dt, _t(v))), ref):
        np.testing.assert_allclose(a, np.asarray(b), **F32)
    res = jv(_t(w), _t(w0), dt, _t(v), b=_t(w0))   # the form b - J v
    for a, b, c in zip(state_to_numpy(res), w0, ref):
        np.testing.assert_allclose(a, b - np.asarray(c), **F32)
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(_t(w), _t(w0), dt, _t(v))


def test_box_plan_refusals():
    pb2, pb3 = bench2.make(nx=8, ny=8), bench3.make(nx=8, ny=8)
    with pytest.raises(NotImplementedError, match="coupled"):
        pb2.kernel_jvp(pb2.grid, "cpu", split=True, form="box")
    g3 = dataclasses.replace(pb3.grid, rule_name="dunavant2")
    with pytest.raises(NotImplementedError, match="4-point"):
        pb3.kernel_jvp(g3, "cpu", form="box")
    launch = pb3.kernel_jvp(pb3.grid, "cpu").launch
    mask = torch.zeros((2,) + pb3.grid.vshape)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        tri_box.TriBoxPlan(dataclasses.replace(launch, mask=mask))
    with pytest.raises(NotImplementedError, match="no instantiation"):
        tri_box.TriBoxPlan(dataclasses.replace(launch, kind="ch3d"))
    # at BM6's physics the mask is taken, and counted apart
    assert tri_box.TriBoxPlan(dataclasses.replace(
        launch, kind="chp", mask=mask)).name == "tri_box_chp"


@pytest.mark.parametrize("name", ["bench1", "bench2", "bench3"])
@pytest.mark.parametrize("tiled", [False, True])
def test_outer_jvp_and_exported_az_take_the_box_form(name, tiled):
    from pfhubbenchmarks_tpu_torch.ops.fem_tile import multi_block

    n = 14 if name == "bench3" else 16
    pb = {"bench1": bench1.make, "bench2": bench2.make,
          "bench3": bench3.make}[name](nx=n, ny=n)
    assert pb.outer_jvp_form == "box"
    if tiled:
        pb = dataclasses.replace(pb, solver=dataclasses.replace(
            pb.solver, tiled_grid_kernels=True))
    made = []
    kernel_jvp = pb.kernel_jvp

    def recording(g, device, dirichlet=(), split=False, form="gather"):
        made.append((g.nx, g.rule_name, split, form))
        return kernel_jvp(g, device, dirichlet, split=split, form=form)

    pb = dataclasses.replace(pb, kernel_jvp=recording)
    outer = (n, "ffc3", False,
             "recompute" if tiled and multi_block(pb.grid) else "box")
    factory = pb.lowp_jvp_factory("cpu")
    assert made == [outer]
    build = pb.precond_builder("cpu")
    # the exported A z: the true-rule fine grid, the coupled operator
    assert (n, "ffc3", False, "box") in made[1:]
    assert all(f != "box" for (_, r, _, f) in made[1:] if r != "ffc3")
    # on the CPU both give the plain version's values
    w, v, _ = _inputs(pb, seed=5)
    w, v, dt = _t(w), _t(v), 0.125
    plain = kernel_jvp(pb.grid, "cpu").plain
    for a, b in zip(factory(w, w, dt)(v), plain(w, w, dt, v)):
        assert torch.equal(a, b)
    z, az = build(w, w, dt).minv_matvec(v)
    for a, b in zip(az, plain(w, w, dt, z)):
        assert torch.equal(a, b)


def test_bench6_outer_jvp_takes_the_box_form():
    """bench6's outer J.v is kernel W at BM6's physics with its Dirichlet
    rows (the box form); its levels stay kernel E's gather form, and with
    Dirichlet rows on the fine level it exports no A z."""
    pb = bench6.make(nx=16, ny=16)
    assert pb.outer_jvp_form == "box"
    made = []
    kernel_jvp = pb.kernel_jvp

    def recording(g, device, dirichlet=(), split=False, form="gather"):
        made.append((g.nx, g.rule_name, form, bool(dirichlet)))
        return kernel_jvp(g, device, dirichlet, split=split, form=form)

    pb = dataclasses.replace(pb, kernel_jvp=recording)
    jv = pb.lowp_jvp_factory("cpu")
    assert made == [(16, "ffc3", "box", True)]
    build = pb.precond_builder("cpu")
    assert all(f == "gather" for (_, r, f, _) in made[1:] if r != "ffc3")
    w = tuple(t.float() for t in pb.initial_state("cpu"))
    v = tuple(torch.ones_like(t) for t in w)
    assert not hasattr(build(w, w, 0.01), "minv_matvec")
    box = kernel_jvp(pb.grid, "cpu", pb.dirichlet, form="box")
    assert box.plan.name == "tri_box_chp" and box.plan.mask is not None
    plain = kernel_jvp(pb.grid, "cpu", pb.dirichlet).plain
    for a, b in zip(jv(w, w, 0.01)(v), plain(w, w, 0.01, v)):
        assert torch.equal(a, b)
