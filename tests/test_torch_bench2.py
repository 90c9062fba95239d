"""The port's bench2 pieces against the JAX package, on seeded numpy inputs:

- ``forms.d2h`` and both hand-written tangents (coupled and field-split)
  against ``torch.func`` (f64, 1e-12);
- the f64 residual, TFE and solute at the bench2 IC plus noise (rel 1e-12);
- the split block-Jacobi planes: cross-group planes exactly 0, and the
  planes against the JAX package's;
- kernel F's plain version (``chac_jvp``) against ``make_pallas_jvp`` in
  interpret mode at 16^2: coupled at ffc3, split at dunavant1, both forms;
- the field groups of ops/lmr.py: contiguous ranges only, one LMR step per
  group.

The sweeps and the field-split V-cycle are held against the JAX package in
tests/test_torch_bench2_sweeps.py; each file stays near a minute on a CPU
(interpret-mode Pallas at six fields traces slowly).

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5): the two sides sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_jvp
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import (Bench2Params,
                                                         make as make_torch,
                                                         make_terms,
                                                         make_terms_tangent)
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext, make_residual
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.models import forms
from pfhubbenchmarks_tpu_torch.ops.lmr import group_starts, lmr_step_plain
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
F = 6
GROUPS = ((0, 1), (2,), (3,), (4,), (5,))


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair, dtype=torch.float32):
    return state_from_numpy(pair, "cpu", dtype)


def _states(n, seed, dtype=np.float32):
    """(w, w0, v): bench2's IC plus seeded noise, the IC, a random
    direction."""
    pj = make_jax(nx=n, ny=n)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = tuple(a + 0.02 * rng.standard_normal(a.shape) for a in w0)
    v = tuple(rng.standard_normal(a.shape) for a in w0)
    return tuple(tuple(a.astype(dtype) for a in p) for p in (w, w0, v))


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _close(got, ref):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F32)


def test_d2h_is_the_derivative_of_dh():
    u = torch.tensor(np.random.default_rng(0).uniform(-0.5, 1.5, 64),
                     dtype=torch.float64)
    _, ref = torch.func.jvp(forms.dh, (u,), (torch.ones_like(u),))
    assert float((forms.d2h(u) - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("num_eta", [1, 2, 4])
def test_terms_tangent_matches_jvp(split, num_eta):
    p = Bench2Params()
    terms = make_terms(p, num_eta, split=split)
    tangent = make_terms_tangent(p, num_eta, split=split)
    nf = 2 + num_eta
    rng = np.random.default_rng(3 + num_eta)
    shape = (4, 3, 5, 6)

    def r(*s, loc=0.0, scale=1.0):
        return torch.tensor(loc + scale * rng.standard_normal(s),
                            dtype=torch.float64)

    u = (r(*shape, loc=0.5, scale=0.1), r(*shape)) + tuple(
        r(*shape, loc=0.3, scale=0.3) for _ in range(num_eta))
    du = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(nf))
    u0 = tuple(r(*shape) for _ in range(nf))
    du0 = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(nf))
    tu = tuple(r(*shape) for _ in range(nf))
    tdu = tuple((r(4, 1, 5, 6), r(4, 1, 5, 6)) for _ in range(nf))
    dt = 0.37

    def flat(u_, du_):
        s, f = terms(QPContext(u=u_, du=du_, u0=u0, du0=du0, dt=dt))
        return tuple(s) + tuple(x for fi in f for x in fi)

    _, ref = torch.func.jvp(flat, (u, du), (tu, tdu))
    s, f = tangent(QPContext(u=u, du=du, u0=u0, du0=du0, dt=dt),
                   QPContext(u=tu, du=tdu, u0=None, du0=None, dt=None))
    got = tuple(s) + tuple(x for fi in f for x in fi)
    assert len(got) == len(ref) == 3 * nf
    for a, b in zip(got, ref):
        a, b = torch.broadcast_tensors(a, b)
        assert float((a - b).abs().max()) <= 1e-12 * max(float(b.abs().max()), 1.0)


def test_residual_and_observables_match_jax_f64():
    n = 16
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, w0, _ = _states(n, seed=0, dtype=np.float64)
    for terms_j, terms_t in ((pj.terms, pt.terms),
                             (pj.terms_precond, pt.terms_precond)):
        rj = jax_residual(pj.grid, terms_j, F)(_j(w), _j(w0), 0.05)
        rt = make_residual(pt.grid, terms_t, F, device="cpu")(
            _t(w, torch.float64), _t(w0, torch.float64), 0.05)
        for a, b in zip(state_to_numpy(rt), rj):
            assert _rel(a, np.asarray(b)) <= 1e-12
    for state in (w, w0):
        obs_j = {k: float(f(_j(state))) for k, f in pj.observable_fns().items()}
        obs_t = {k: float(f(_t(state, torch.float64)))
                 for k, f in pt.observable_fns("cpu").items()}
        assert obs_j.keys() == obs_t.keys()
        for k in obs_j:
            assert abs(obs_t[k] - obs_j[k]) <= 1e-12 * abs(obs_j[k])
    assert pt.field_groups == pj.field_groups == GROUPS


def test_split_block_jacobi_is_block_diagonal():
    n, dt = 8, 0.05
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    w, w0, _ = _states(n, seed=1)
    planes = make_block_jacobi(pt.grid, pt.terms_precond, F, device="cpu")(
        _t(w), _t(w0), dt).pinv_planes
    partners = {i: set(g) for g in GROUPS for i in g}
    for plane in planes:
        for i in range(F):
            for j in range(F):
                if j not in partners[i]:
                    assert torch.all(plane[i, j] == 0.0), (i, j)
    planes_j = jax.jit(lambda a, b: jax_bj(
        pj.grid, pj.terms_precond, F, dtype=jnp.float32)(a, b, dt).pinv_planes)(
        _j(w), _j(w0))
    _close([p.numpy() for p in planes], planes_j)
    # the coupled terms give dense blocks: the coupling is real
    full = make_block_jacobi(pt.grid, pt.terms, F, device="cpu")(
        _t(w), _t(w0), dt).pinv_planes
    assert float(full[0][0, 2].abs().max()) > 0


@pytest.mark.parametrize("split", [False, True])
def test_chac_jvp_matches_pallas_jvp(split):
    n, dt = 16, 0.05
    pj, pt = make_jax(nx=n, ny=n), make_torch(nx=n, ny=n)
    rule = "dunavant1" if split else "ffc3"
    gj = dataclasses.replace(pj.grid, rule_name=rule)
    gt = dataclasses.replace(pt.grid, rule_name=rule)
    w, w0, v = _states(n, seed=2)
    ref = make_pallas_jvp(gj, pj.terms_precond if split else pj.terms, F)(
        _j(w), _j(w0), dt, _j(v), interpret=True)
    jv = pt.kernel_jvp(gt, "cpu", split=split)
    _close(state_to_numpy(jv(_t(w), _t(w0), dt, _t(v))), ref)
    res = jv(_t(w), _t(w0), dt, _t(v), b=_t(w0))   # the form b - J v
    _close(state_to_numpy(res), [a - np.asarray(b) for a, b in zip(w0, ref)])
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(_t(w), _t(w0), dt, _t(v))


@pytest.mark.parametrize("groups, starts", [
    (None, None), (GROUPS, (0, 2, 3, 4, 5, 6)), (((0,), (1, 2)), (0, 1, 3))])
def test_group_starts(groups, starts):
    assert group_starts(groups) == starts


@pytest.mark.parametrize("bad", [((1, 0),), ((0,), (2,)), ((0, 2), (1,)),
                                 ((0,), ())])
def test_group_starts_refuse_non_contiguous_groups(bad):
    with pytest.raises(ValueError):
        group_starts(bad)


def test_grouped_lmr_step_is_one_step_per_group():
    """C's plain version with groups: each group takes the ungrouped step on
    its own fields."""
    rng = np.random.default_rng(12)
    x, r, z, az = (tuple(torch.tensor(rng.standard_normal((F,) + s),
                                      dtype=torch.float32)
                         for s in ((5, 5), (4, 4))) for _ in range(4))
    xg, rg = tuple(t.clone() for t in x), tuple(t.clone() for t in r)
    lmr_step_plain(xg, rg, z, az, GROUPS)
    for a, b in zip(group_starts(GROUPS)[:-1], group_starts(GROUPS)[1:]):
        xs, rs = (tuple(t[a:b].clone() for t in p) for p in (x, r))
        lmr_step_plain(xs, rs, tuple(t[a:b] for t in z), tuple(t[a:b] for t in az))
        for got, want in zip(xg + rg, xs + rs):
            torch.testing.assert_close(got[a:b], want, rtol=0, atol=0)
