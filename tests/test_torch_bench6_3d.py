"""The port's bench6_3d pieces against the JAX package, on seeded numpy
inputs:

- ``DirichletBC3D`` on each of the six faces of a 4 x 5 x 6 grid:
  ``apply_value`` and ``apply_residual`` equal to the JAX package's, and
  ``bc_mask3d`` the 0/1 plane of the same rows;
- the f64 residual with its BC rows ``u - g``, the total free energy and the
  solute at 8^3 (rel 1e-12);
- the plain J.v of kernel U at BM6's physics (``chp3d_tile``) with the
  Dirichlet mask, at 8^3 and ffc3, against ``torch.func.jvp`` of the port's
  f32 residual and ``jax.linearize`` of the JAX package's; its BC rows are
  ``v`` (and ``b - v``) exactly;
- ``make_block_jacobi3d`` with unit BC rows against the JAX package's (f64,
  rel 1e-12);
- one cycle apply at 25^3 (levels 25/5, the ratio-5 pair, ffc3, the dense
  5^3 inverse, zeroed BC rows on both transfers) against ``make_gmg3d`` on
  the XLA path, with the port's sweep loop (kernel L's plain version);
- the refusals of the CHP3 wrappers, and the bench6_3d CLI at 8^3.

The JAX package's traces are shared through module-scoped fixtures. f32
tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4, atol 2e-5 x
max|ref|): the two sides sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench6_3d import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly3d import DirichletBC3D as JaxBC3D
from pfhubbenchmarks_tpu.fem.grid3d import TetGrid as JaxTetGrid
from pfhubbenchmarks_tpu.solve.gmg3d import make_gmg3d as jax_gmg3d
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi3d as jax_bj3d
from pfhubbenchmarks_tpu_torch.benchmarks.bench6_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.fem.assembly3d import (DirichletBC3D,
                                                      bc_mask3d)
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d

F = 3
DT = 0.3


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4,
                               atol=2e-5 * max(float(np.abs(ref).max()), 1.0))


def _rel(got, ref):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(ref)))
                 / np.max(np.abs(np.asarray(ref))))


def _states(pt, seed, dtype=np.float64):
    """The IC with its BC values plus seeded noise, the previous state, and
    two random directions, as numpy arrays [3, Z, Y, X]."""
    (w0,) = pt.initial_state("cpu")
    rng = np.random.default_rng(seed)
    w = w0.numpy() + 0.05 * rng.standard_normal(w0.shape)
    wp = w0.numpy() + 0.05 * rng.standard_normal(w0.shape)
    v, b = (rng.standard_normal(w0.shape) for _ in range(2))
    return tuple(a.astype(dtype) for a in (w, wp, v, b))


@pytest.mark.parametrize("face", ["x0", "x1", "y0", "y1", "z0", "z1"])
def test_dirichlet_bc3d_matches_jax(face):
    gj, gt = JaxTetGrid(4, 5, 6, 8.0, 10.0, 9.0), TetGrid(4, 5, 6, 8.0, 10.0, 9.0)

    def fn(c1, c2):
        return np.sin(c1 / 3.0) + 0.5 * c2 + 0.25 * c1 * c2

    bj, bt = JaxBC3D.make(gj, 1, face, fn), DirichletBC3D.make(gt, 1, face, fn)
    np.testing.assert_array_equal(bt.g, bj.g)
    assert (bt.field, bt.face, bt.index) == (bj.field, bj.face, bj.index)
    rng = np.random.default_rng(3)
    v, rv = (rng.standard_normal((2,) + gt.vshape) for _ in range(2))
    np.testing.assert_array_equal(bt.apply_value(torch.tensor(v)).numpy(),
                                  np.asarray(bj.apply_value(jnp.asarray(v))))
    np.testing.assert_array_equal(
        bt.apply_residual(torch.tensor(rv), torch.tensor(v)).numpy(),
        np.asarray(bj.apply_residual(jnp.asarray(rv), jnp.asarray(v))))
    # the mask: 1 exactly on the face's rows of the field inside the grid
    mask = bc_mask3d(gt, (bt,), 2)
    ones = np.zeros((2,) + gt.vshape)
    ones[:, : gt.nz + 1, : gt.ny + 1, : gt.nx + 1] = 1.0
    marked = np.asarray(JaxBC3D(field=1, face=face, g=np.zeros_like(bj.g),
                                index=bj.index).apply_value(jnp.asarray(ones)))
    np.testing.assert_array_equal(mask, (ones - marked).astype(np.float32))
    assert bc_mask3d(gt, (), 2) is None


def test_residual_and_observables_match_jax():
    pj, pt = make_jax(nx=8, ny=8, nz=8), make_torch(nx=8, ny=8, nz=8)
    w, wp, _, _ = _states(pt, 5)
    (ref,) = pj.residual()((jnp.asarray(w),), (jnp.asarray(wp),), DT)
    (got,) = pt.residual("cpu")((torch.tensor(w),), (torch.tensor(wp),), DT)
    assert _rel(got, ref) <= 1e-12
    # the BC rows are u - g on both x faces of phi
    for bc in pt.dirichlet:
        np.testing.assert_allclose(bc.rows(got).numpy(),
                                   bc.rows(torch.tensor(w)).numpy() - bc.g,
                                   rtol=0, atol=1e-15)
    obs_j, obs_t = pj.observable_fns(), pt.observable_fns("cpu")
    for name in ("total_free_energy", "total_solute"):
        a = float(obs_j[name]((jnp.asarray(w),)))
        b = float(obs_t[name]((torch.tensor(w),)))
        assert abs(b - a) <= 1e-12 * abs(a), name
    # the IC carries the BC values
    (v0,) = pt.initial_state("cpu")
    np.testing.assert_array_equal(v0.numpy(), np.asarray(pj.initial_state()[0]))


@pytest.fixture(scope="module")
def jvp_case():
    """The port's and the JAX package's f32 J.v of bench6_3d at 8^3, ffc3,
    with the BC rows, on one seeded state and direction."""
    pj, pt = make_jax(nx=8, ny=8, nz=8), make_torch(nx=8, ny=8, nz=8)
    w, wp, v, b = _states(pt, 9, np.float32)
    res_j = pj.residual(dtype=jnp.float32)
    _, lin = jax.linearize(
        lambda u: res_j((u,), (jnp.asarray(wp),), DT)[0], jnp.asarray(w))
    jax_jv = np.asarray(lin(jnp.asarray(v)))
    res_t = pt.residual("cpu", dtype=torch.float32)
    wt, wpt = (torch.tensor(w),), (torch.tensor(wp),)
    _, (fwd,) = torch.func.jvp(lambda u: res_t(u, wpt, DT), (wt,),
                               ((torch.tensor(v),),))
    jv = pt.kernel_jvp(pt.grid, "cpu", pt.dirichlet)
    return pt, jv, (wt, wpt, torch.tensor(v), torch.tensor(b)), jax_jv, fwd


def test_plain_jvp_with_mask_matches_forward_ad_and_jax(jvp_case):
    pt, jv, (wt, wpt, v, b), jax_jv, fwd = jvp_case
    assert pt.grid.tab().nq == 8 and jv.launch.kind == "chp3d"
    (got,) = jv(wt, wpt, DT, (v,))
    _close(got, fwd)
    _close(got, jax_jv)
    (got_b,) = jv(wt, wpt, DT, (v,), b=(b,))
    _close(got_b, b - fwd)
    mask = jv.launch.mask.numpy() != 0
    assert mask.sum() == 2 * 9 * 9
    assert torch.equal(got[torch.tensor(mask)], v[torch.tensor(mask)])
    assert torch.equal(got_b[torch.tensor(mask)],
                       (b - v)[torch.tensor(mask)])
    np.testing.assert_array_equal(mask, bc_mask3d(pt.grid, pt.dirichlet, F) != 0)


def test_chp3d_wrappers_refuse_what_they_do_not_take(jvp_case):
    pt, jv, (wt, wpt, v, _), _, _ = jvp_case
    with pytest.raises(ValueError, match="CUDA"):
        jv.kernel(wt, wpt, DT, (v,))
    with pytest.raises(NotImplementedError, match="not built"):
        jv.gather(wt, wpt, DT, (v,))
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make13

    p13 = make13(nx=4, ny=4, nz=4)
    with pytest.raises(NotImplementedError, match="Dirichlet"):
        p13.kernel_jvp(p13.grid, "cpu", pt.dirichlet_for(p13.grid))
    # L at CHP3 takes the level's mask and counts under its own name
    from pfhubbenchmarks_tpu_torch.ops import _lib, lmr

    assert _lib.COUNTED_AS[("lmr_sweep", "chp3d")] == "lmr_loop_chp3d"
    assert {"chp3d_tile", "lmr_loop_chp3d"} <= set(_lib.KERNELS)
    x = (torch.zeros_like(v),)
    pinv = (torch.zeros((F, F) + pt.grid.vshape),)
    with pytest.raises(ValueError, match="CUDA"):
        lmr.lmr_sweep_kernel(jv.launch, 2, x, (v.clone(),), wt, DT, pinv)


def test_block_jacobi3d_with_bc_rows_matches_jax():
    pj, pt = make_jax(nx=6, ny=6, nz=6), make_torch(nx=6, ny=6, nz=6)
    w, wp, _, _ = _states(pt, 7)
    ref = jax_bj3d(pj.grid, pj.terms, F, dirichlet=pj.dirichlet,
                   dtype=jnp.float64)((jnp.asarray(w),), (jnp.asarray(wp),),
                                      DT).pinv_planes
    (got,) = make_block_jacobi3d(pt.grid, pt.terms_tangent, F, device="cpu",
                                 dirichlet=pt.dirichlet, dtype=torch.float64)(
        (torch.tensor(w),), (torch.tensor(wp),), DT).pinv_planes
    assert got.shape == ref.shape
    assert _rel(got.numpy(), ref) <= 1e-12
    # a BC row of phi is the unit row
    np.testing.assert_allclose(got[2, :, 3, 4, 0].numpy(), [0.0, 0.0, 1.0],
                               rtol=0, atol=1e-14)


def test_cycle_apply_with_bc_rows_matches_jax_xla_cycle():
    pj, pt = make_jax(nx=25, ny=25, nz=25), make_torch(nx=25, ny=25, nz=25)
    w, wp, v, _ = _states(pt, 15, np.float32)
    s = pj.solver
    build_t = pt.precond_builder("cpu")
    assert [g.nx for g in build_t.grids] == [25, 5] and build_t.dense_coarse
    assert all(g.tab().nq == 8 for g in build_t.grids)
    build_j = jax_gmg3d(pj.grid, pj.terms, F, dirichlet_for=pj.dirichlet_for,
                        dtype=jnp.float32, nu_pre=s.gmg_nu_pre,
                        nu_post=s.gmg_nu_post)
    # jitted: the eager cycle dispatches (and compiles) op by op
    (ref,) = jax.jit(lambda w_, p_, v_: build_j((w_,), (p_,), DT)((v_,)))(
        jnp.asarray(w), jnp.asarray(wp), jnp.asarray(v))
    (got,) = build_t((torch.tensor(w),), (torch.tensor(wp),), DT)(
        (torch.tensor(v),))
    _close(got, ref)


def test_bench6_3d_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b63d.csv"
    main("bench6_3d", ["--device", "cpu", "--nx", "8", "--ny", "8", "--nz",
                       "8", "--max-steps", "1", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1, ndmin=2)
    assert rows.shape == (1, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.01])
    if not torch.cuda.is_available():
        # the default device is the card
        with pytest.raises(SystemExit, match="no CUDA device"):
            main("bench6_3d", ["--nx", "8", "--ny", "8", "--nz", "8",
                               "--max-steps", "1", "--out", str(out)])
