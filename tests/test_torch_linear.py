"""The port's f64 linear branch against the JAX package, piece by piece, on
seeded numpy inputs:

- ``qpoint_coords`` in 2D and 3D: equal;
- the f64 residual with coordinate terms and its BC rows (poisson 16^2,
  poisson3d 6^3) at a random state: rel 1e-13 of max |ref|;
- the functionals with coordinates (l2_error_sq, energy): rel 1e-13;
- ``eval_at_points`` at random points (and the corners and edges) on a
  random state, and ``sample_grid``: 1e-14 of max |ref|;
- the f64 block-Jacobi inverse planes with Dirichlet rows, 2D (poisson,
  elast) and 3D (poisson3d, by ``make_block_jacobi3d_terms``), and their
  apply: rel 1e-13;
- ``make_dense_precond`` on a 20 x 4 elast beam: J against the JAX
  package's chunked ``jax.linearize`` columns to 1e-12 of max |J|, and
  ``Minv(r)`` against its LAPACK path to rel 1e-10; 'mxu' refused;
- the f64 Newton branch on the skew system of tests/test_solvers.py (cp line
  search, identity preconditioner): the same root to rel 1e-9 and the same
  Newton count as ``make_newton_solver(mixed_precision=False)``; mixed
  precision without an f32 operator refused.

The slices through ``timeloop.run`` are in tests/test_torch_linear_slices.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.elast import make as jax_elast
from pfhubbenchmarks_tpu.benchmarks.poisson import make as jax_poisson
from pfhubbenchmarks_tpu.benchmarks.poisson3d import make as jax_poisson3d
from pfhubbenchmarks_tpu.config import SolverConfig as JaxSolverConfig
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.fem.grid import CrossedTriGrid as JaxGrid
from pfhubbenchmarks_tpu.fem.grid3d import TetGrid as JaxTetGrid
from pfhubbenchmarks_tpu.fem.sample import eval_at_points as jax_eval
from pfhubbenchmarks_tpu.fem.sample import sample_grid as jax_sample_grid
from pfhubbenchmarks_tpu.solve.newton import make_newton_solver as jax_newton
from pfhubbenchmarks_tpu.solve.precond import (make_block_jacobi as jax_bj,
                                               make_block_jacobi3d as jax_bj3d,
                                               make_dense_precond as jax_dense)
from pfhubbenchmarks_tpu_torch.benchmarks.elast import make as torch_elast
from pfhubbenchmarks_tpu_torch.benchmarks.poisson import make as torch_poisson
from pfhubbenchmarks_tpu_torch.benchmarks.poisson3d import make as torch_poisson3d
from pfhubbenchmarks_tpu_torch.config import SolverConfig
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.fem.sample import eval_at_points, sample_grid
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.solve.newton import make_newton_solver
from pfhubbenchmarks_tpu_torch.solve.precond import (make_block_jacobi,
                                                     make_block_jacobi3d_terms,
                                                     make_dense_precond)

DT = 1.0


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _pair_rel(got, ref):
    return max(_rel(g, r) for g, r in zip(state_to_numpy(got), ref))


def _random_state(pj, seed, scale=1.0):
    """The JAX problem's initial state (BC values set) plus seeded noise on
    the logical nodes, as a tuple of numpy arrays."""
    rng = np.random.default_rng(seed)
    return tuple(np.asarray(a) + scale * rng.standard_normal(np.shape(a))
                 for a in pj.initial_state())


@pytest.fixture(scope="module")
def problems():
    """(JAX, port) problem pairs at the sizes of these tests."""
    return {
        "poisson": (jax_poisson(nx=16, ny=16), torch_poisson(nx=16, ny=16)),
        "poisson3d": (jax_poisson3d(nx=6, ny=6, nz=6),
                      torch_poisson3d(nx=6, ny=6, nz=6)),
        "elast": (jax_elast(nx=20, ny=4, Lx=5.0),
                  torch_elast(nx=20, ny=4, Lx=5.0)),
    }


def test_qpoint_coords_equal_jax():
    for gj, gt in ((JaxGrid(5, 3, 2.0, 1.5), CrossedTriGrid(5, 3, 2.0, 1.5)),
                   (JaxGrid(4, 6, 1.0, 3.0, rule_name="dunavant2"),
                    CrossedTriGrid(4, 6, 1.0, 3.0, rule_name="dunavant2")),
                   (JaxTetGrid(3, 4, 5, 1.0, 2.0, 0.5),
                    TetGrid(3, 4, 5, 1.0, 2.0, 0.5))):
        for a, b in zip(gt.qpoint_coords(), gj.qpoint_coords()):
            assert a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["poisson", "poisson3d"])
def test_residual_with_coordinates_matches_jax(problems, name):
    pj, pt = problems[name]
    w, w0 = _random_state(pj, 1), _random_state(pj, 2)
    ref = pj.residual()(tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)),
                        DT)
    got = pt.residual("cpu")(state_from_numpy(w, "cpu"),
                             state_from_numpy(w0, "cpu"), DT)
    assert _pair_rel(got, ref) < 1e-13


@pytest.mark.parametrize("name", ["poisson", "poisson3d"])
def test_functionals_with_coordinates_match_jax(problems, name):
    pj, pt = problems[name]
    w = _random_state(pj, 3)
    obs_j, obs_t = pj.observable_fns(), pt.observable_fns("cpu")
    assert set(obs_t) == set(obs_j) == {"l2_error_sq", "energy"}
    for key in obs_j:
        ref = float(obs_j[key](tuple(map(jnp.asarray, w))))
        got = float(obs_t[key](state_from_numpy(w, "cpu")))
        assert abs(got - ref) <= 1e-13 * abs(ref), (key, got, ref)


def test_eval_at_points_matches_jax():
    gj, gt = JaxGrid(7, 5, 3.5, 2.0), CrossedTriGrid(7, 5, 3.5, 2.0)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((2,) + gt.vshape),
         rng.standard_normal((2,) + gt.mshape))
    xs = np.concatenate([rng.uniform(0.0, 3.5, 200), [0.0, 3.5, 3.5, 0.0, 1.75]])
    ys = np.concatenate([rng.uniform(0.0, 2.0, 200), [0.0, 0.0, 2.0, 2.0, 1.0]])
    ref = np.asarray(jax_eval(gj, tuple(map(jnp.asarray, w)), xs, ys))
    got = eval_at_points(gt, state_from_numpy(w, "cpu"), xs, ys)
    assert got.shape == ref.shape == (2, 205)
    assert float(np.max(np.abs(got.numpy() - ref))) <= 1e-14 * np.abs(ref).max()
    # a scalar point gives one value per field
    one = eval_at_points(gt, state_from_numpy(w, "cpu"), 3.5, 1.0)
    assert one.shape == (2,)
    sj, st = (jax_sample_grid(gj, tuple(map(jnp.asarray, w)), 9, 6),
              sample_grid(gt, state_from_numpy(w, "cpu"), 9, 6))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-14 * 4)


@pytest.mark.parametrize("name", ["poisson", "elast"])
def test_block_jacobi_f64_2d_matches_jax(problems, name):
    pj, pt = problems[name]
    w, w0 = _random_state(pj, 5, 0.1), _random_state(pj, 6, 0.1)
    build_j = jax_bj(pj.grid, pj.terms, pj.n_fields, dirichlet=pj.dirichlet,
                     dtype=jnp.float64, needs_coords=pj.needs_coords)
    planes_j = jax.jit(lambda a, b: build_j(a, b, DT).pinv_planes)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)))
    Mt = make_block_jacobi(pt.grid, pt.terms, pt.n_fields, device="cpu",
                           dirichlet=pt.dirichlet, dtype=torch.float64,
                           needs_coords=pt.needs_coords)(
        state_from_numpy(w, "cpu"), state_from_numpy(w0, "cpu"), DT)
    for got, ref in zip(Mt.pinv_planes, planes_j):
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), ref) < 1e-13
    # the apply, against the JAX package's einsum on its planes
    r = _random_state(pj, 7)
    ref = [np.einsum("ijyx,jyx->iyx", np.asarray(P), rl)
           for P, rl in zip(planes_j, r)]
    assert _pair_rel(Mt(state_from_numpy(r, "cpu")), ref) < 1e-13


def test_block_jacobi_f64_3d_matches_jax(problems):
    pj, pt = problems["poisson3d"]
    w, w0 = _random_state(pj, 8, 0.1), _random_state(pj, 9, 0.1)
    Mj = jax_bj3d(pj.grid, pj.terms, 1, dirichlet=pj.dirichlet,
                  dtype=jnp.float64, needs_coords=True)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)), DT)
    build = pt.precond_builder("cpu")
    Mt = build(state_from_numpy(w, "cpu"), state_from_numpy(w0, "cpu"), DT)
    (planes,) = Mt.pinv_planes
    assert planes.dtype == torch.float64
    assert _rel(planes.numpy(), Mj.pinv_planes) < 1e-13
    # the Dirichlet rows are unit rows: P^-1 = 1 there
    assert float(planes[0, 0, 0].abs().max() - 1.0) == 0.0
    r = _random_state(pj, 10)
    assert _pair_rel(Mt(state_from_numpy(r, "cpu")),
                     Mj(tuple(map(jnp.asarray, r)))) < 1e-13
    ref = make_block_jacobi3d_terms(pt.grid, pt.terms, 1, device="cpu",
                                    dirichlet=pt.dirichlet, needs_coords=True)
    assert torch.equal(ref(state_from_numpy(w, "cpu"),
                           state_from_numpy(w0, "cpu"), DT).pinv_planes[0],
                       planes)


def _jax_dense_jacobian(pj, w, w0):
    """J of the JAX package's flattened f64 residual, as its
    ``make_dense_precond`` forms it: ``jax.linearize`` and ``jax.vmap`` over
    one-hot rows (the grid has no padding: pad_to (1, 1))."""
    g = pj.grid
    F = pj.n_fields
    res = jax_residual(g, pj.terms, F, dirichlet=pj.dirichlet,
                       dtype=jnp.float64)
    nv = F * (g.ny + 1) * (g.nx + 1)

    def flat(p):
        return jnp.concatenate([p[0].reshape(-1), p[1].reshape(-1)])

    def unflat(x):
        return (x[:nv].reshape(F, g.ny + 1, g.nx + 1),
                x[nv:].reshape(F, g.ny, g.nx))

    x0 = flat(tuple(map(jnp.asarray, w)))
    w0j = tuple(map(jnp.asarray, w0))
    _, jvp = jax.linearize(lambda x: flat(res(unflat(x), w0j, DT)), x0)
    return np.asarray(jax.vmap(jvp)(jnp.eye(x0.size))).T


def test_dense_precond_matches_jax(problems):
    pj, pt = problems["elast"]
    w, w0 = _random_state(pj, 11, 1e-3), _random_state(pj, 12, 1e-3)
    build = make_dense_precond(pt.grid, pt.terms, 2, device="cpu",
                               dirichlet=pt.dirichlet, chunk=100)
    J = build.jacobian(state_from_numpy(w, "cpu"), state_from_numpy(w0, "cpu"),
                       DT).numpy()
    J_ref = _jax_dense_jacobian(pj, w, w0)
    n = 2 * (5 * 21 + 4 * 20)
    assert J.shape == J_ref.shape == (n, n)
    assert float(np.abs(J - J_ref).max()) <= 1e-12 * np.abs(J_ref).max()
    Mj = jax_dense(pj.grid, pj.terms, 2, dirichlet=pj.dirichlet,
                   dtype=jnp.float64, impl="lapack", chunk=100)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w0)), DT)
    Mt = build(state_from_numpy(w, "cpu"), state_from_numpy(w0, "cpu"), DT)
    assert Mt.inverse.dtype == torch.float64
    for seed in (13, 14):
        r = _random_state(pj, seed)
        assert _pair_rel(Mt(state_from_numpy(r, "cpu")),
                         Mj(tuple(map(jnp.asarray, r)))) < 1e-10
    with pytest.raises(NotImplementedError, match="mxu"):
        make_dense_precond(pt.grid, pt.terms, 2, device="cpu", impl="mxu")


def _skew_system():
    """tests/test_solvers.py's cp-line-search system: a near-skew rotation
    block plus a cubic term."""
    theta = np.pi / 2 - 1e-3
    R = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    A = np.kron(R, np.eye(8))
    b = np.random.default_rng(7).standard_normal(16)
    return A, b


def test_f64_newton_branch_matches_jax():
    A, b = _skew_system()
    kw = dict(newton_atol=1e-10, newton_max_iters=25, krylov_rtol=1e-10,
              line_search="cp", mixed_precision=False)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    solve_j = jax_newton(lambda u, up, dt: Aj @ u + 0.01 * u**3 - bj,
                         JaxSolverConfig(**kw), lambda w, w0, dt: (lambda r: r))
    xj = jnp.zeros_like(bj)
    ref = solve_j(xj, xj, 1.0)
    At, bt = torch.tensor(A), torch.tensor(b)
    solve_t = make_newton_solver(
        lambda w, wp, dt: (At @ w[0] + 0.01 * w[0] ** 3 - bt,),
        SolverConfig(precond="none", **kw),
        lambda w, w0, dt: (lambda r: r), lowp_jvp_factory=None)
    x0 = (torch.zeros_like(bt),)
    got = solve_t(x0, x0, 1.0)
    assert bool(ref.converged) and got.converged
    assert got.iters == int(ref.iters)
    assert got.x[0].dtype == torch.float64
    assert _rel(got.x[0].numpy(), ref.x) < 1e-9
    with pytest.raises(ValueError, match="lowp_jvp_factory"):
        make_newton_solver(lambda w, wp, dt: w, SolverConfig(),
                           lambda w, w0, dt: (lambda r: r),
                           lowp_jvp_factory=None)
