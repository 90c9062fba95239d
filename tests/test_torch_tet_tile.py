"""Kernel U (``csrc/fem_tet_tile.cuh``, the 3D J.v over shared-memory tet
boxes) on the CPU, where it cannot run:

- the box geometry its launcher uses (``ops/fem_jvp3d.TET_BOX``, held equal
  to the C++ constants): the owned boxes cover every vertex once, and each
  box's cells are exactly the cells incident to its owned vertices, on 8^3,
  7x5x3 and 25^3 cells (26^3 vertices, partial boxes at the edges);
- a numpy transliteration of U's box body, with its per-tet rows (the
  source part per point, the flux part once per tet through
  w_q = sum_K WB[q][K]) and its summation order (each cell's tets in order
  into its 8 slot sums; the slot sums into each owned vertex, slots in
  order), against the plain version (f64 1e-12, f32 at the
  tolerances of tests/test_pallas_vcycle.py: rtol 2e-4, atol 2e-5 x
  max|ref|), at keast2 and ffc3;
- the transliteration against the JAX package's ``make_tiled_jvp3d`` (TPU
  row 16) in interpret mode at 8^3 (keast2, the levels' rule; one case: the
  interpret-mode trace takes ~20 s);
- that a CPU tensor takes the plain version and a direct call of U (and of
  I) raises without CUDA.
"""

import dataclasses
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.ops import pallas3d
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import Bench1Params, kernel_constants
from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.fem.assembly3d import make_tangent_jvp3d
from pfhubbenchmarks_tpu_torch.fem.grid3d import _SLOT_XYZ, _TETS
from pfhubbenchmarks_tpu_torch.ops import fem_jvp3d
from test_torch_bench1_3d import _inputs

F = 2
CSRC = Path(fem_jvp3d.__file__).resolve().parent.parent / "csrc"
GEOMETRIES = [(8, 8, 8), (3, 5, 7), (25, 25, 25)]   # (nz, ny, nx) cells


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4,
                               atol=2e-5 * max(float(np.abs(ref).max()), 1.0))


def _cuda_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / "fem_tet_tile.cuh").read_text()).group(1))


def test_box_constants_are_the_kernels():
    assert fem_jvp3d.TET_BOX == tuple(_cuda_constant(f"kBox{a}") for a in "ZYX")
    # the launcher's box count, ceil((n + 1) / B) along each axis
    src = (CSRC / "fem_tet_tile.cuh").read_text()
    assert ("return static_cast<long>((nz + kBoxZ) / kBoxZ) * ((ny + kBoxY) / "
            "kBoxY)\n         * ((nx + kBoxX) / kBoxX);") in src


@pytest.mark.parametrize("dims", GEOMETRIES)
def test_boxes_cover_vertices_once_and_their_cells(dims):
    nz, ny, nx = dims
    owned = np.zeros((nz + 1, ny + 1, nx + 1), int)
    evaluated = np.zeros(dims, int)
    for box in itertools.product(*(range(n) for n in fem_jvp3d.tet_boxes(dims))):
        (vz, cz), (vy, cy), (vx, cx) = fem_jvp3d.box_ranges(dims, box)
        assert len(vz) and len(vy) and len(vx)
        owned[vz.start:vz.stop, vy.start:vy.stop, vx.start:vx.stop] += 1
        # the cells incident to the owned vertices
        want = np.zeros(dims, bool)
        for s in range(8):
            dx, dy, dz = _SLOT_XYZ[s]
            want[max(vz.start - dz, 0):min(vz.stop - dz, nz),
                 max(vy.start - dy, 0):min(vy.stop - dy, ny),
                 max(vx.start - dx, 0):min(vx.stop - dx, nx)] = True
        got = np.zeros(dims, bool)
        got[cz.start:cz.stop, cy.start:cy.stop, cx.start:cx.stop] = True
        np.testing.assert_array_equal(got, want)
        evaluated[got] += 1
        # the box's cells fit its staged (B + 1)^3 cells
        assert all(len(c) <= b + 1 for c, b in zip((cz, cy, cx),
                                                   fem_jvp3d.TET_BOX))
    assert np.all(owned == 1)
    assert fem_jvp3d.recompute_factor(dims) == pytest.approx(
        evaluated.sum() / np.prod(dims), rel=1e-12)


def test_recompute_factor_of_the_bench1_3d_levels():
    # 51 vertices in boxes of 7: 7 + 8 x 6 + 2 cells per axis; 26: 7 + 8 x 2 + 5
    assert fem_jvp3d.recompute_factor((50, 50, 50)) == pytest.approx(1.14 ** 3)
    assert fem_jvp3d.recompute_factor((25, 25, 25)) == pytest.approx(1.12 ** 3)


def _tables(grid, dtype):
    """The kernels' tables (Jvp3Params) in ``dtype``: Bq [nq, 4], and per
    tet WB [nq, 4] and Gs [4, 3] over its own 4 vertices."""
    tab = grid.tab()
    Bq = tab.Bq[0][:, _TETS[0]]
    WB = np.stack([(tab.wq[t][:, None] * tab.Bq[t])[:, _TETS[t]]
                   for t in range(6)])
    Gs = np.stack([tab.Gs[t][_TETS[t]] for t in range(6)])
    return Bq.astype(dtype), WB.astype(dtype), Gs.astype(dtype)


def _ch3_tangent(k, dt, c, d, g):
    """phys_ch3d.cuh's CH3::tangent: (src [F], flux [F][3])."""
    M, kappa, rho_s, ca, cb = k
    a, b = c - ca, cb - c
    fpp = 2 * rho_s * ((b - a) * (b - a) - 2 * a * b)
    src = (d[0] / dt, d[1] - fpp * d[0])
    flux = ([M * g[1][i] for i in range(3)], [-kappa * g[0][i] for i in range(3)])
    return src, flux


def tet_box_jvp(grid, k, dt, w, v, b=None, dtype=np.float64):
    """U's box body in numpy: out = J v (or b - J v) on the vertex grid,
    box by box, in the kernel's order (csrc/fem_tet_tile.cuh)."""
    dims = (grid.nz, grid.ny, grid.nx)
    Bq, WB, Gs = _tables(grid, dtype)
    k = np.asarray(k, dtype)
    dt = dtype(dt)
    w, v = np.asarray(w, dtype), np.asarray(v, dtype)
    out = np.zeros_like(v)
    for box in itertools.product(*(range(n) for n in fem_jvp3d.tet_boxes(dims))):
        (vz, cz), (vy, cy), (vx, cx) = fem_jvp3d.box_ranges(dims, box)

        def corner(a, s):  # a's value at slot s of each of the box's cells
            dx, dy, dz = _SLOT_XYZ[s]
            return a[..., cz.start + dz:cz.stop + dz, cy.start + dy:cy.stop + dy,
                     cx.start + dx:cx.stop + dx]

        # the cells' slot sums cs[s][f], tets in order
        rows = []
        for t in range(6):
            wc = [corner(w[0], s) for s in _TETS[t]]
            d = [[corner(v[f], s) for s in _TETS[t]] for f in range(F)]
            g = [[sum((Gs[t, j, a] * d[f][j] for j in range(1, 4)),
                      Gs[t, 0, a] * d[f][0]) for a in range(3)] for f in range(F)]
            r = [[dtype(0)] * F for _ in range(4)]
            phi = [[dtype(0)] * 3 for _ in range(F)]
            for q in range(Bq.shape[0]):
                c = sum((Bq[q, j] * wc[j] for j in range(1, 4)), Bq[q, 0] * wc[0])
                dq = [sum((Bq[q, j] * d[f][j] for j in range(1, 4)),
                          Bq[q, 0] * d[f][0]) for f in range(F)]
                src, flux = _ch3_tangent(k, dt, c, dq, g)
                wq = WB[t, q, 0] + WB[t, q, 1] + WB[t, q, 2] + WB[t, q, 3]
                for f in range(F):
                    for a in range(3):
                        phi[f][a] = phi[f][a] + wq * flux[f][a]
                    for kk in range(4):
                        r[kk][f] = r[kk][f] + WB[t, q, kk] * src[f]
            rows.append([[r[kk][f] + (Gs[t, kk, 0] * phi[f][0]
                                      + Gs[t, kk, 1] * phi[f][1]
                                      + Gs[t, kk, 2] * phi[f][2])
                          for f in range(F)] for kk in range(4)])
        cs = [[dtype(0)] * F for _ in range(8)]
        for s in range(8):
            for t in range(6):
                if s in _TETS[t]:
                    kk = list(_TETS[t]).index(s)
                    cs[s] = [cs[s][f] + rows[t][kk][f] for f in range(F)]

        # the owned vertices: their cells' slot sums, slots in order
        acc = np.zeros((F, len(vz), len(vy), len(vx)), dtype)
        for s in range(8):
            dx, dy, dz = _SLOT_XYZ[s]
            # owned vertex o is slot s of cell o - d, where that cell is in
            # the grid; the box's cell index is (o - d) - c.start
            oz = [z for z in vz if 0 <= z - dz < grid.nz]
            oy = [y for y in vy if 0 <= y - dy < grid.ny]
            ox = [x for x in vx if 0 <= x - dx < grid.nx]
            if not (oz and oy and ox):
                continue
            sl = (slice(oz[0] - vz.start, oz[-1] + 1 - vz.start),
                  slice(oy[0] - vy.start, oy[-1] + 1 - vy.start),
                  slice(ox[0] - vx.start, ox[-1] + 1 - vx.start))
            cl = (slice(oz[0] - dz - cz.start, oz[-1] + 1 - dz - cz.start),
                  slice(oy[0] - dy - cy.start, oy[-1] + 1 - dy - cy.start),
                  slice(ox[0] - dx - cx.start, ox[-1] + 1 - dx - cx.start))
            for f in range(F):
                acc[(f,) + sl] = acc[(f,) + sl] + cs[s][f][cl]
        out[:, vz.start:vz.stop, vy.start:vy.stop, vx.start:vx.stop] = acc
    return out if b is None else np.asarray(b, dtype) - out


def _state(grid, seed):
    pt = make_torch(nx=grid.nx, ny=grid.ny, nz=grid.nz)
    (w0,) = grid.interpolate(pt.ic_fns)
    rng = np.random.default_rng(seed)
    w = w0 + 0.05 * rng.standard_normal(w0.shape)
    v, b = (rng.standard_normal(w0.shape) for _ in range(2))
    return pt, w, v, b


@pytest.mark.parametrize("rule", ["keast2", "ffc3"])
def test_box_body_matches_the_plain_version(rule):
    # partial boxes on every axis: 7, 10 and 11 vertices
    pt = make_torch(nx=10, ny=9, nz=6)
    g = dataclasses.replace(pt.grid, rule_name=rule)
    _, w, v, b = _state(g, 5)
    k = [kernel_constants(Bench1Params())[n] for n in fem_jvp3d.CH_CONSTANTS]
    dt = 0.4
    # f64: the same function to rounding
    plain64 = make_tangent_jvp3d(g, pt.terms_tangent, device="cpu",
                                 dtype=torch.float64)
    (ref,) = plain64((torch.tensor(w),), None, dt, (torch.tensor(v),))
    got = tet_box_jvp(g, k, dt, w, v)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-12,
                               atol=1e-12 * float(ref.abs().max()))
    # f32: the plain version the wrapper takes on the CPU
    jv = pt.kernel_jvp(g, "cpu")
    w32, v32, b32 = (a.astype(np.float32) for a in (w, v, b))
    (ref32,) = jv.plain((torch.tensor(w32),), None, dt, (torch.tensor(v32),))
    _close(tet_box_jvp(g, k, dt, w32, v32, dtype=np.float32), ref32)
    (ref32b,) = jv.plain((torch.tensor(w32),), None, dt, (torch.tensor(v32),),
                         b=(torch.tensor(b32),))
    _close(tet_box_jvp(g, k, dt, w32, v32, b=b32, dtype=np.float32), ref32b)


def test_box_body_matches_tiled_pallas():
    pj, pt, gj, gt, w, v, _ = _inputs(8, 12)
    prep, jv_t = pallas3d.make_tiled_jvp3d(gj, pj.terms, F, dtype=jnp.float32,
                                           block_rows=4, interpret=True)
    wj = (jnp.asarray(w),)
    (ref,) = jv_t((jnp.asarray(v),), prep(wj, wj), 0.4)
    k = [kernel_constants(Bench1Params())[n] for n in fem_jvp3d.CH_CONSTANTS]
    _close(tet_box_jvp(gt, k, 0.4, w, v, dtype=np.float32), ref)


def test_cpu_tensors_take_the_plain_version_and_the_kernels_raise():
    pt = make_torch(nx=4, ny=4, nz=4)
    g = dataclasses.replace(pt.grid, rule_name="keast2")
    _, w, v, _ = _state(g, 9)
    jv = pt.kernel_jvp(g, "cpu")
    wt, vt = ((torch.tensor(a, dtype=torch.float32),) for a in (w, v))
    assert torch.equal(jv(wt, wt, 0.4, vt)[0], jv.plain(wt, wt, 0.4, vt)[0])
    for launch in (jv.kernel, jv.gather):
        with pytest.raises(ValueError, match="CUDA"):
            launch(wt, wt, 0.4, vt)
