"""The port's bench3 pieces against the JAX package, on seeded numpy inputs:

- the IC, the f64 residual and the observables (TFE, the solid fraction
  scaled by the domain area) at 24^2 (rel 1e-12);
- the hand-written AC + heat tangent against ``torch.func.jvp`` of the
  ported ``terms`` (f64, 1e-12);
- kernel G's plain version (``ach_jvp``) against ``make_pallas_jvp`` in
  interpret mode, both rules (ffc3, dunavant2), both forms, at 16^2;
- block-Jacobi planes against the JAX package's (f32 tolerance);
- the parameters and configs carry over; the host loop stops on
  ``abort_condition``, keeping the row. (The anisotropic form:
  tests/test_torch_bench3_aniso.py.)

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench3 import Bench3Params as JaxParams
from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import (Bench3Params,
                                                         kernel_constants,
                                                         make as make_torch,
                                                         make_terms)
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext
from pfhubbenchmarks_tpu_torch.interop import (problem_params_from_numpy,
                                               solver_config_from_dict,
                                               state_from_numpy, state_to_numpy,
                                               time_config_from_dict)
from pfhubbenchmarks_tpu_torch.ops.ach_jvp import make_ach_jvp
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
F = 2


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair, dtype=torch.float32):
    return state_from_numpy(pair, "cpu", dtype)


def _states(n, seed, dtype=np.float32):
    """(w, w0, v): bench3's IC plus seeded noise, the IC itself, and a
    random direction."""
    pj = make_jax(nx=n, ny=n)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = tuple(a + 0.05 * rng.standard_normal(a.shape) for a in w0)
    v = tuple(rng.standard_normal(a.shape) for a in w0)
    return tuple(tuple(a.astype(dtype) for a in p) for p in (w, w0, v))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_residual_and_observables_match_jax_f64():
    n = 24
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    for a, b in zip(state_to_numpy(pt.initial_state("cpu")), pj.initial_state()):
        np.testing.assert_array_equal(a, np.asarray(b))
    w, w0, _ = _states(n, seed=0, dtype=np.float64)
    rj = pj.residual()(_j(w), _j(w0), 0.05)
    rt = pt.residual("cpu")(_t(w, torch.float64), _t(w0, torch.float64), 0.05)
    for a, b in zip(state_to_numpy(rt), rj):
        assert _rel(a, np.asarray(b)) <= 1e-12
    obs_j = {k: float(f(_j(w))) for k, f in pj.observable_fns().items()}
    obs_t = {k: float(f(_t(w, torch.float64)))
             for k, f in pt.observable_fns("cpu").items()}
    assert obs_j.keys() == obs_t.keys() == {"total_free_energy", "solid_fraction"}
    for k in obs_j:
        assert abs(obs_t[k] - obs_j[k]) <= 1e-12 * abs(obs_j[k])
    # scaled by 1 / (Lx Ly): the seed's share of the domain
    sf = float(pt.observable_fns("cpu")["solid_fraction"](_t(w0, torch.float64)))
    assert 0.0 < sf < 0.01


def test_terms_tangent_matches_jvp():
    terms, terms_tangent, _ = make_terms(Bench3Params())
    rng = np.random.default_rng(3)
    shape = (4, 3, 5, 6)

    def r(*s):
        return torch.tensor(rng.standard_normal(s), dtype=torch.float64)

    u = (-0.3 + 0.1 * r(*shape), r(*shape))
    du = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(F))
    u0 = (-0.3 + 0.1 * r(*shape), r(*shape))
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
def test_ach_jvp_matches_pallas_jvp(rule):
    n = 16
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    w, w0, v = _states(n, seed=2)
    dt = 0.05
    rv, rm = make_pallas_jvp(gj, pj.terms, F)(_j(w), _j(w0), dt, _j(v),
                                              interpret=True)
    ref = (np.asarray(rv), np.asarray(rm))
    jv = make_ach_jvp(gt, make_terms(Bench3Params())[1],
                      kernel_constants(Bench3Params()), device="cpu")
    out = jv(_t(w), _t(w0), dt, _t(v))
    for a, b in zip(state_to_numpy(out), ref):
        np.testing.assert_allclose(a, b, **F32)
    res = jv(_t(w), _t(w0), dt, _t(v), b=_t(w0))   # the form b - J v
    for a, b, c in zip(state_to_numpy(res), w0, ref):
        np.testing.assert_allclose(a, b - c, **F32)
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(_t(w), _t(w0), dt, _t(v))


def test_block_jacobi_matches_jax():
    n = 16
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, w0, _ = _states(n, seed=1)
    dt = 0.05
    planes_j = jax.jit(lambda a, b: jax_bj(
        pj.grid, pj.terms, F, dtype=jnp.float32)(a, b, dt).pinv_planes)(
            _j(w), _j(w0))
    mt = make_block_jacobi(pt.grid, pt.terms, F, device="cpu")(_t(w), _t(w0), dt)
    for a, b in zip(mt.pinv_planes, planes_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_configs_and_params_carry_over():
    pj, pt = make_jax(), make_torch()
    assert dataclasses.asdict(pt.solver) == dataclasses.asdict(pj.solver)
    assert dataclasses.asdict(pt.time) == dataclasses.asdict(pj.time)
    assert solver_config_from_dict(dataclasses.asdict(pj.solver)) == pt.solver
    assert time_config_from_dict(dataclasses.asdict(pj.time)) == pt.time
    p = problem_params_from_numpy(
        {k: np.asarray(v)[()] for k, v in dataclasses.asdict(JaxParams()).items()},
        Bench3Params)
    assert p == Bench3Params() and isinstance(p.m, int)
    assert p.lam == JaxParams().lam
    assert pt.observable_scale == pj.observable_scale
    assert pt.csv_columns == pj.csv_columns
    # the hierarchy of the published size and its dense 7^2 coarsest level
    build = pt.precond_builder("cpu")
    assert [g.nx for g in build.grids] == [350, 175, 35, 7]
    assert build.dense_coarse   # 2 (8^2 + 7^2) = 226 dofs <= 1500


def test_host_loop_stops_on_abort_condition():
    seen = []

    def abort(row):
        seen.append(row)
        return row["time"] > 0.02

    pt = make_torch(nx=14, ny=14, abort_condition=abort)
    res = timeloop.run(pt, device="cpu", max_steps=5, verbose=False)
    np.testing.assert_allclose(res.rows[:, 0], [0.01, 0.03])
    assert [sorted(r) for r in seen] == [sorted(pt.csv_columns)] * 2
    # bench3's own condition: TFE < 0
    assert make_torch(nx=14, ny=14).abort_condition(
        {"time": 1.0, "total_free_energy": -1.0, "solid_fraction": 0.1})
