"""The port's 3D discretisation against the JAX package, on seeded numpy
inputs (f64):

- the tet rules, the Kuhn-tet tabulations and the node diagonals equal the
  JAX package's arrays;
- bench1_3d's residual and its TFE and solute functionals at 8^3 (rel
  1e-12), and the IC's solute at 50^3 equal to row 1 of
  ``results/bench1_3d_out.csv`` (rel 1e-9: solute is conserved);
- the transfers (solve/transfer3d.py) against the JAX package's at ratio 2
  (8^3 <-> 4^3) and 5 (10^3 <-> 2^3), to 1e-12, and the adjoint identity
  <P x, y> = <x, R y> of the written-out restriction;
- the 3D block-Jacobi planes (built from the hand-written tangent) against
  ``make_block_jacobi3d`` of the JAX package (``jax.jvp`` of ``terms``), at
  1e-12.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1_3d import make as make_jax
from pfhubbenchmarks_tpu.fem import grid3d as jgrid3d
from pfhubbenchmarks_tpu.fem import quadrature as jquad
from pfhubbenchmarks_tpu.fem.assembly3d import make_functional3d as jax_functional
from pfhubbenchmarks_tpu.fem.assembly3d import make_residual3d as jax_residual
from pfhubbenchmarks_tpu.solve import transfer3d as jt3
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi3d as jax_bj3d
from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.fem import grid3d, quadrature
from pfhubbenchmarks_tpu_torch.fem.assembly3d import (make_functional3d,
                                                      make_residual3d)
from pfhubbenchmarks_tpu_torch.io.csvout import read_csv
from pfhubbenchmarks_tpu_torch.solve import transfer3d as t3
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("keast1", "keast2", "ffc2", "ffc3", "fiat3")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _states(n, seed):
    """(w, w0): bench1_3d's IC at n^3 plus seeded noise, and the IC."""
    (w0,) = make_jax(nx=n, ny=n, nz=n).initial_state()
    w0 = np.asarray(w0)
    rng = np.random.default_rng(seed)
    return (w0 + 0.05 * rng.standard_normal(w0.shape),), (w0,)


@pytest.mark.parametrize("name", RULES)
def test_tet_rules_match_jax(name):
    got, ref = quadrature.get_tet_rule(name), jquad.get_tet_rule(name)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.weights, ref.weights)
    assert got.name == ref.name
    assert quadrature.tet_monomial_integral(2, 1, 1) == \
        jquad.tet_monomial_integral(2, 1, 1)


@pytest.mark.parametrize("name", RULES)
def test_tabulation_and_diagonals_match_jax(name):
    g = grid3d.TetGrid(6, 5, 4, 12.0, 10.0, 9.0, rule_name=name)
    jg = jgrid3d.TetGrid(6, 5, 4, 12.0, 10.0, 9.0, rule_name=name)
    got, ref = g.tab(), jg.tab()
    for f in ("Bq", "Gs", "wq", "xq"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    dg, dr = g.node_diagonals(), jg.node_diagonals()
    assert dg.keys() == dr.keys()
    for k in dg:
        np.testing.assert_array_equal(dg[k], dr[k])
    np.testing.assert_array_equal(np.stack(g.vertex_coords()),
                                  np.stack(jg.vertex_coords()))
    np.testing.assert_array_equal(grid3d._SLOT_XYZ, jgrid3d._SLOT_XYZ)
    np.testing.assert_array_equal(grid3d._TETS, jgrid3d._TETS)


@pytest.mark.parametrize("rule", ["ffc3", "keast2"])
def test_residual_and_functionals_match_jax(rule):
    pj, pt = make_jax(nx=8, ny=8, nz=8), make_torch(nx=8, ny=8, nz=8)
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    w, w0 = _states(8, 3)
    (ref,) = jax_residual(gj, pj.terms, 2)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)), 0.7)
    (got,) = make_residual3d(gt, pt.terms, 2, device="cpu")(
        tuple(map(torch.tensor, w)), tuple(map(torch.tensor, w0)), 0.7)
    assert _rel(got.numpy(), ref) <= 1e-12
    for name in ("total_free_energy", "total_solute"):
        ref = float(jax_functional(gj, pj.observables[name])(
            tuple(map(jnp.asarray, w))))
        got = float(make_functional3d(gt, pt.observables[name], device="cpu")(
            tuple(map(torch.tensor, w))))
        assert abs(got - ref) <= 1e-12 * abs(ref)


def test_initial_state_matches_jax_and_reference_solute():
    pt = make_torch(nx=8, ny=8, nz=8)
    (ref,) = make_jax(nx=8, ny=8, nz=8).initial_state()
    (got,) = pt.initial_state("cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # at the published 50^3 the IC's solute is row 1's (solute is conserved)
    rows, cols = read_csv(os.path.join(REPO, "results", "bench1_3d_out.csv"))
    p50 = make_torch()
    solute = float(p50.observable_fns("cpu")["total_solute"](
        p50.initial_state("cpu")))
    assert cols[2] == "total_solute" and rows.shape == (24, 3)
    assert abs(solute - rows[0, 2]) <= 1e-9 * rows[0, 2]


@pytest.mark.parametrize("fine_n, coarse_n", [(8, 4), (10, 2)])
def test_transfers_match_jax(fine_n, coarse_n):
    fine = grid3d.TetGrid(fine_n, fine_n, fine_n, 1.0, 1.0, 1.0)
    coarse = dataclasses.replace(fine, nx=coarse_n, ny=coarse_n, nz=coarse_n)
    jfine = jgrid3d.TetGrid(fine_n, fine_n, fine_n, 1.0, 1.0, 1.0)
    jcoarse = dataclasses.replace(jfine, nx=coarse_n, ny=coarse_n, nz=coarse_n)
    rng = np.random.default_rng(fine_n)
    xc = (rng.standard_normal((2,) + coarse.vshape),)
    yf = (rng.standard_normal((2,) + fine.vshape),)
    pairs = [(t3.prolong3d_any, jt3.prolong3d_any, xc),
             (t3.restrict3d_any, jt3.restrict3d_any, yf),
             (t3.inject3d_any, jt3.inject3d_any, yf)]
    if fine_n == 2 * coarse_n:   # the general form at ratio 2 too
        pairs += [(t3.prolong3d_general, jt3.prolong3d_general, xc),
                  (t3.restrict3d_general, jt3.restrict3d_general, yf)]
    for port, jax_fn, arg in pairs:
        (got,) = port(coarse, fine)(tuple(map(torch.tensor, arg)))
        (ref,) = (jax_fn(jcoarse, jfine)(tuple(map(jnp.asarray, arg))),)
        ref = ref[0] if isinstance(ref, tuple) else ref
        assert got.shape == ref.shape
        assert _rel(got.numpy(), ref) <= 1e-12, (port.__name__, _rel(got, ref))
    # the written-out restriction is the prolongation's transpose
    (px,) = t3.prolong3d_any(coarse, fine)(tuple(map(torch.tensor, xc)))
    (ry,) = t3.restrict3d_any(coarse, fine)(tuple(map(torch.tensor, yf)))
    lhs = float(torch.vdot(px.reshape(-1), torch.tensor(yf[0]).reshape(-1)))
    rhs = float(torch.vdot(torch.tensor(xc[0]).reshape(-1), ry.reshape(-1)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_block_jacobi3d_matches_jax():
    pj, pt = make_jax(nx=6, ny=6, nz=6), make_torch(nx=6, ny=6, nz=6)
    gj = dataclasses.replace(pj.grid, rule_name="keast2")
    gt = dataclasses.replace(pt.grid, rule_name="keast2")
    w, w0 = _states(6, 5)
    ref = jax_bj3d(gj, pj.terms, 2, dtype=jnp.float64)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)),
        0.3).pinv_planes
    (got,) = make_block_jacobi3d(gt, pt.terms_tangent, 2, device="cpu",
                                 dtype=torch.float64)(
        tuple(map(torch.tensor, w)), tuple(map(torch.tensor, w0)),
        0.3).pinv_planes
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-12
