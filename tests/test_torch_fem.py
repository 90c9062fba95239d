"""The PyTorch port's FEM layer against the JAX package: quadrature and
tabulations (exact), the f64 residual and functionals (rel 1e-12), and the
Tier-1 library smoke at 100^2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax
from pfhubbenchmarks_tpu.fem import quadrature as jq
from pfhubbenchmarks_tpu.fem.assembly import make_functional as jax_functional
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.fem.grid import CrossedTriGrid as JaxGrid
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import make as make_torch
from pfhubbenchmarks_tpu_torch.fem import quadrature as tq
from pfhubbenchmarks_tpu_torch.fem.assembly import make_functional, make_residual
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy

RULES = ["ffc3", "dunavant1", "dunavant2", "dunavant4"]


@pytest.mark.parametrize("rule", RULES)
def test_rules_and_tabulations_equal_jax(rule):
    a, b = jq.get_rule(rule), tq.get_rule(rule)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.weights, b.weights)
    gj = JaxGrid(16, 12, 40.0, 30.0, rule_name=rule)
    gt = CrossedTriGrid(16, 12, 40.0, 30.0, rule_name=rule)
    tj, tt = gj.tab(), gt.tab()
    for name in ("Bq", "Gs", "wq", "xq"):
        np.testing.assert_array_equal(getattr(tj, name), getattr(tt, name))
    dj, dt_ = gj.node_diagonals(), gt.node_diagonals()
    for k in dj:
        for x, y in zip(dj[k], dt_[k]):
            np.testing.assert_array_equal(x, y)


def _perturbed_states(n=16, seed=0):
    """bench1's IC plus a seeded perturbation (w) and the IC itself (w0)."""
    pj = make_jax(nx=n, ny=n)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = tuple(a + 0.01 * rng.standard_normal(a.shape) for a in w0)
    return pj, w, w0


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_f64_residual_matches_jax():
    pj, w, w0 = _perturbed_states()
    pt = make_torch(nx=16, ny=16)
    dt = 0.37
    rj = jax_residual(pj.grid, pj.terms, 2, dtype=jnp.float64)(
        tuple(jnp.asarray(a) for a in w), tuple(jnp.asarray(a) for a in w0), dt)
    rt = make_residual(pt.grid, pt.terms, 2, device="cpu")(
        state_from_numpy(w, "cpu"), state_from_numpy(w0, "cpu"), dt)
    for a, b in zip(state_to_numpy(rt), rj):
        assert _rel(a, np.asarray(b)) <= 1e-12


@pytest.mark.parametrize("name", ["total_free_energy", "total_solute"])
def test_f64_functionals_match_jax(name):
    pj, w, _ = _perturbed_states(seed=1)
    pt = make_torch(nx=16, ny=16)
    vj = float(jax_functional(pj.grid, pj.observables[name])(
        tuple(jnp.asarray(a) for a in w)))
    vt = float(make_functional(pt.grid, pt.observables[name], device="cpu")(
        state_from_numpy(w, "cpu")))
    assert abs(vt - vj) <= 1e-12 * abs(vj)


def test_tier1_smoke_100():
    """Total solute of the BM1 IC on the 100^2 reference grid (row 1 of
    results/bench1_out.csv; solute is conserved) and its TFE."""
    p = make_torch()
    w = p.initial_state("cpu")
    obs = p.observable_fns("cpu")
    solute = float(obs["total_solute"](w))
    tfe = float(obs["total_free_energy"](w))
    assert abs(solute - 20504.46905508) <= 1e-8 * 20504.46905508
    assert abs(tfe - 297.6737) <= 1e-4
    assert w[0].dtype == torch.float64
