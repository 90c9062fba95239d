"""The port's bench1_3d pieces against the JAX package, on seeded numpy
inputs:

- the hand-written 3D Cahn-Hilliard tangent (bench1's ``terms_tangent``,
  which kernel I mirrors) against ``torch.func.jvp`` of the ported
  ``terms`` (f64, 1e-12);
- kernel I's plain version (ops/fem_jvp3d.py) against TPU kernel 14
  (``make_pallas_jvp3d``'s kernel body, built here as an interpret-mode
  ``pallas_call``, as tests/test_pallas3d.py does; both forms) and kernel 16
  (``make_tiled_jvp3d``, interpret mode, ``block_rows`` 4 and nz) at 8^3 and
  keast2, the levels' rule (the trace of the unrolled 8-point ffc3 body
  costs ~20 s a case in interpret mode; the plain version is one einsum
  assembly for every rule, and the slice test runs it at ffc3);
- the bench1_3d CLI at 10^3 for 2 steps.

The sweep loop and the K-cycle are in tests/test_torch_bench1_3d_sweeps.py.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4,
atol 2e-5 x max|ref|): the two sides sum in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pfhubbenchmarks_tpu.benchmarks.bench1_3d import make as make_jax
from pfhubbenchmarks_tpu.ops import pallas3d
from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext

F = 2


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4,
                               atol=2e-5 * max(float(np.abs(ref).max()), 1.0))


def _inputs(n, seed, rule="keast2"):
    """(jax problem, port problem, jax grid, port grid, w, v, b): the IC plus
    seeded noise as the f32 state, and two random directions."""
    pj, pt = make_jax(nx=n, ny=n, nz=n), make_torch(nx=n, ny=n, nz=n)
    (w0,) = pt.grid.interpolate(pt.ic_fns)
    rng = np.random.default_rng(seed)
    w = (w0 + 0.05 * rng.standard_normal(w0.shape)).astype(np.float32)
    v, b = (rng.standard_normal(w0.shape).astype(np.float32) for _ in range(2))
    return (pj, pt, dataclasses.replace(pj.grid, rule_name=rule),
            dataclasses.replace(pt.grid, rule_name=rule), w, v, b)


def test_tangent_matches_forward_ad():
    pt = make_torch(nx=4, ny=4, nz=4)
    rng = np.random.default_rng(7)
    shape = (6, 4, 3, 3, 3)

    def r(*s):
        return torch.tensor(rng.standard_normal(s or shape))

    u, u0, du = (r(), r()), (r(), r()), tuple((r(), r(), r()) for _ in range(F))
    tu, tdu = (r(), r()), tuple((r(), r(), r()) for _ in range(F))

    def flat(u_, du_):
        src, flux = pt.terms(QPContext(u=u_, du=du_, u0=u0, du0=None, dt=0.3))
        return tuple(src) + tuple(f for fl in flux for f in fl)

    _, ref = torch.func.jvp(flat, (u, du), (tu, tdu))
    src, flux = pt.terms_tangent(
        QPContext(u=u, du=du, u0=u0, du0=None, dt=0.3),
        QPContext(u=tu, du=tdu, u0=None, du0=None, dt=None))
    got = tuple(src) + tuple(f for fl in flux for f in fl)
    for a, b in zip(got, ref):
        torch.testing.assert_close(torch.broadcast_to(a, b.shape), b,
                                   rtol=1e-12, atol=1e-12)


def _whole_array_jvp3d(grid, terms, dt, w, v):
    """TPU kernel 14's body (make_pallas_jvp3d) as an interpret-mode
    pallas_call."""
    residual = pallas3d._scalar_assembly3d(grid, terms, F)
    Z, Y, X = grid.vshape

    def kernel(w_v, w0_v, v_v, dt_ref, out_v):
        _, jv = jax.jvp(lambda u: residual(u, (w0_v[:],), dt_ref[0, 0]),
                        ((w_v[:],),), ((v_v[:],),))
        pallas3d._scatter_refs3d(jv, out_v, F, grid.nz, grid.ny, grid.nx)

    call = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((F, Z, Y, X), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3
        + [pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM), interpret=True)
    return call(jnp.asarray(w), jnp.asarray(w), jnp.asarray(v),
                jnp.asarray([[dt]], jnp.float32))


def test_kernel_i_plain_matches_whole_array_pallas():
    pj, pt, gj, gt, w, v, b = _inputs(8, 11)
    ref = _whole_array_jvp3d(gj, pj.terms, 0.4, w, v)
    jv = pt.kernel_jvp(gt, "cpu")
    wt, vt, bt = ((torch.tensor(a),) for a in (w, v, b))
    (got,) = jv(wt, wt, 0.4, vt)
    _close(got, ref)
    (got_b,) = jv(wt, wt, 0.4, vt, b=bt)
    _close(got_b, b - np.asarray(ref))


@pytest.mark.parametrize("block_rows", [4, 8])
def test_kernel_i_plain_matches_tiled_pallas(block_rows):
    pj, pt, gj, gt, w, v, _ = _inputs(8, 12)
    prep, jv_t = pallas3d.make_tiled_jvp3d(gj, pj.terms, F, dtype=jnp.float32,
                                           block_rows=block_rows, interpret=True)
    wj = (jnp.asarray(w),)
    (ref,) = jv_t((jnp.asarray(v),), prep(wj, wj), 0.4)
    wt = (torch.tensor(w),)
    (got,) = pt.kernel_jvp(gt, "cpu")(wt, wt, 0.4, (torch.tensor(v),))
    _close(got, ref)


def test_bench1_3d_cli_writes_reference_schema_csv(tmp_path):
    out = tmp_path / "b13d.csv"
    main("bench1_3d", ["--device", "cpu", "--nx", "10", "--ny", "10", "--nz",
                       "10", "--max-steps", "2", "--quiet", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert lines[0] == "time,total_free_energy,total_solute"
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (2, 3) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows[:, 0], [0.1, 0.3])
