"""Kernel R's plain version (ops/fem_residual.py: the f32 residual that the
fast cp line search reads) against the JAX package, on seeded numpy inputs:

- against ``make_pallas_residual`` in interpret mode at bench1 12^2 (rtol
  and atol 1e-5, as tests/test_pallas.py:22-28);
- against the JAX package's f32 XLA residual at bench6 16^2, Dirichlet rows
  included, and bench2 12^2 (rtol 1e-5, atol 1e-5 times max|R|: the source
  (c - c0)/dt cancels);
- Python transliterations of the CUDA ``Phys::residual`` of
  csrc/phys_ch.cuh, phys_chp.cuh and phys_chac.cuh against the benchmarks'
  ``terms`` (f64, 1e-12);
- the Dirichlet planes the kernel takes (mask and g) give the rows u - g of
  ``DirichletBC.apply_residual``;
- ``residual_lowp`` is kernel R's wrapper where the benchmark has one;
- ``benchmarks/attempts.py`` records every solve attempt with either
  residual.

On this CPU the wrapper runs the plain version; ``chip_smoke.py`` holds the
CUDA kernel against it on the card.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks import get_benchmark
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_residual
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext, make_residual
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops.fem_residual import dirichlet_planes

PORT = {"bench1": bench1.make, "bench6": bench6.make, "bench2": bench2.make}


def _states(name, n, seed):
    """(jax problem, port problem, w, w0): the f32 IC plus seeded noise and
    the IC."""
    pj = get_benchmark(name, nx=n, ny=n)
    pt = PORT[name](nx=n, ny=n)
    w0 = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    w = tuple((a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
              for a in w0)
    for bc in pt.dirichlet:   # keep the Dirichlet values on the rows
        w = (state_to_numpy((bc.apply_value(torch.tensor(w[0])),))[0], w[1])
    return pj, pt, w, w0


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def test_plain_matches_make_pallas_residual():
    """The JAX test's inputs (the IC for both levels, dt 0.1) and
    tolerance."""
    pj, pt, _, w = _states("bench1", 12, 0)
    want = make_pallas_residual(pj.grid, pj.terms, 2)(
        tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, w)), 0.1,
        interpret=True)
    got = pt.residual_lowp("cpu")(_t(w), _t(w), 0.1)
    for a, b in zip(state_to_numpy(got), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,n,dt", [("bench6", 16, 0.32),
                                       ("bench2", 12, 0.16)])
def test_plain_matches_jax_f32_residual(name, n, dt):
    pj, pt, w, w0 = _states(name, n, 1)
    want = pj.residual(dtype=jnp.float32)(tuple(map(jnp.asarray, w)),
                                          tuple(map(jnp.asarray, w0)), dt)
    got = pt.residual_lowp("cpu")(_t(w), _t(w0), dt)
    scale = max(float(np.abs(np.asarray(b)).max()) for b in want)
    for a, b in zip(state_to_numpy(got), want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=1e-5 * scale)


def test_residual_lowp_is_kernel_r():
    for make in (bench1.make, bench6.make, bench2.make):
        p = make(nx=8, ny=8)
        res = p.residual_lowp("cpu")
        assert hasattr(res, "kernel") and hasattr(res, "plain")
        w = p.initial_state("cpu")
        w = tuple(t.float() for t in w)
        want = make_residual(p.grid, p.terms, p.n_fields, device="cpu",
                             dirichlet=p.dirichlet, dtype=torch.float32)(w, w, 0.1)
        assert all(torch.equal(a, b) for a, b in zip(res(w, w, 0.1), want))
    assert not hasattr(bench3.make(nx=8, ny=8).residual_lowp("cpu"), "kernel")


def test_dirichlet_planes_give_the_bc_rows():
    p = bench6.make(nx=10, ny=10)
    rng = np.random.default_rng(2)
    w = tuple(torch.tensor(rng.standard_normal((3,) + s), dtype=torch.float32)
              for s in (p.grid.vshape, p.grid.mshape))
    with_bc = p.residual("cpu", dtype=torch.float32)(w, w, 0.1)
    free = make_residual(p.grid, p.terms, 3, device="cpu",
                         dtype=torch.float32)(w, w, 0.1)
    mask, g = dirichlet_planes(p.grid, p.dirichlet, 3)
    rows = torch.where(torch.tensor(mask) != 0, w[0] - torch.tensor(g), free[0])
    assert torch.equal(rows, with_bc[0]) and torch.equal(free[1], with_bc[1])
    assert dirichlet_planes(p.grid, (), 3) == (None, None)


# ---- transliterations of the CUDA Phys::residual (csrc/phys_*.cuh) --------

def _ch_residual(k, dt, u, gx, gy, u0):
    M, kappa, rho_s, ca, cb = k
    c = u[0]
    a, b = c - ca, cb - c
    return ([(c - u0[0]) / dt, u[1] - 2.0 * rho_s * a * b * (b - a)],
            [M * gx[1], -kappa * gx[0]], [M * gy[1], -kappa * gy[0]])


def _chp_residual(k, dt, u, gx, gy, u0):
    M, kappa, rho, ca, cb, kk, eps = k
    c = u[0]
    a, b = c - ca, cb - c
    return ([(c - u0[0]) / dt,
             u[1] - (2.0 * rho * a * b * (b - a) + kk * u[2]), kk * c / eps],
            [M * gx[1], -kappa * gx[0], -gx[2]],
            [M * gy[1], -kappa * gy[0], -gy[2]])


def _chac_residual(k, dt, u, gx, gy, u0):
    rho2, ca, cb, kc, ke, M, w, alpha, L = k
    ne = len(u) - 2
    c = u[0]

    def h5(e):
        return e * e * e * (6.0 * e * e - 15.0 * e + 10.0)

    def dh(e):
        return (3.0 * e * e * (6.0 * e * e - 15.0 * e + 10.0)
                + e * e * e * (12.0 * e - 15.0))

    H = sum(h5(u[2 + i]) for i in range(ne))
    src = [(c - u0[0]) / dt,
           u[1] - 2.0 * rho2 * ((c - ca) * (1.0 - H) + (c - cb) * H)]
    fx, fy = [M * gx[1], -kc * gx[0]], [M * gy[1], -kc * gy[0]]
    fba = rho2 * (c - cb) * (c - cb) - rho2 * (c - ca) * (c - ca)
    for i in range(ne):
        e = u[2 + i]
        osq = sum(u[2 + j] * u[2 + j] for j in range(ne) if j != i)
        dwell = 2.0 * e * (1.0 - e) * (1.0 - 2.0 * e)
        dfde = fba * dh(e) + w * (dwell + 2.0 * alpha * e * osq)
        src.append((e - u0[2 + i]) / dt + L * dfde)
        fx.append(L * ke * gx[2 + i])
        fy.append(L * ke * gy[2 + i])
    return src, fx, fy


@pytest.mark.parametrize("name", ["bench1", "bench6", "bench2 NE=4",
                                  "bench2 NE=2", "bench2 NE=1"])
def test_cuda_residual_terms_match_terms(name):
    from pfhubbenchmarks_tpu_torch.ops import ch_jvp, chac_jvp, chp_jvp

    if name == "bench1":
        p = bench1.Bench1Params()
        terms, k = bench1.make_terms(p)[0], bench1.kernel_constants(p)
        mirror, names, F = _ch_residual, ch_jvp.CONSTANTS, 2
    elif name == "bench6":
        p = bench6.Bench6Params()
        terms, k = bench6.make_terms(p)[0], bench6.kernel_constants(p)
        mirror, names, F = _chp_residual, chp_jvp.CONSTANTS, 3
    else:
        ne = int(name[-1])
        p = bench2.Bench2Params()
        terms, k = bench2.make_terms(p, ne), bench2.kernel_constants(p)
        mirror, names, F = _chac_residual, chac_jvp.CONSTANTS, 2 + ne
    rng = np.random.default_rng(3)

    def draw():
        return [torch.tensor(rng.uniform(0.0, 1.0, 50)) for _ in range(F)]

    u, u0, gx, gy = draw(), draw(), draw(), draw()
    dt = 0.3
    src, flux = terms(QPContext(u=tuple(u), du=tuple(zip(gx, gy)), u0=tuple(u0),
                                du0=None, dt=dt))
    msrc, mfx, mfy = mirror(tuple(k[n] for n in names), dt, u, gx, gy, u0)
    for f in range(F):
        for got, want in ((msrc[f], src[f]), (mfx[f], flux[f][0]),
                          (mfy[f], flux[f][1])):
            np.testing.assert_allclose(np.asarray(got),
                                       np.asarray(torch.broadcast_to(
                                           torch.as_tensor(want), (50,))),
                                       rtol=1e-12, atol=1e-12)


def test_attempts_record_both_residuals(tmp_path):
    """``benchmarks/attempts.py`` records every solve attempt; on this CPU
    kernel R's wrapper is the f32 einsum assembly, so both runs agree."""
    from pfhubbenchmarks_tpu_torch.benchmarks.attempts import main

    runs = {}
    for residual in ("kernel", "einsum"):
        out = tmp_path / f"{residual}.json"
        main(["bench6", "--rows", "2", "--nx", "12", "--ny", "12", "--device",
              "cpu", "--residual", residual, "--out", str(out)])
        runs[residual] = json.loads(out.read_text())
    assert [a["dt"] for a in runs["kernel"]] == [0.01, 0.02]
    assert runs["kernel"] == runs["einsum"]
    assert all(a["converged"] and len(a["lam"]) == a["newton"]
               for a in runs["kernel"])
