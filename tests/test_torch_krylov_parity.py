"""Where the port's Krylov counts part from the JAX package's: FGMRES's own
f32 arithmetic in the JAX package, not the operators.

bench6 at 24^2 (levels 24/12/6, the coarsest by 24 LMR sweeps): at step 2
(t = 0.03, dt = 0.02) the JAX package's ``timeloop.run`` takes 18 Krylov
iterations where the port takes 14 (Newton 2 and 2). From the JAX
package's own state after step 1, its own f32 operator and its own V-cycle,
the first Newton iteration's linear solve is run three ways:

- the JAX package's ``solve/krylov.fgmres`` in f32, as its Newton runs it;
- the same ``fgmres`` with f64 operands: b in f64, the same f32 operator
  and V-cycle with their outputs cast to f64, so the dots, the basis and the
  Hessenberg least squares run in f64;
- the port's FGMRES (f64-accumulated dots, f32 basis and Hessenberg) with
  the port's own operator and V-cycle at the same state.

The f64 JAX solve takes the port's iteration count, and the f32 one does
not: the port's FGMRES is the better-conditioned arithmetic, and the count
difference at 100^2 (ROADMAP Queue 3 item 1) is the reference's f32
rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax
from pfhubbenchmarks_tpu.solve import krylov as jax_krylov
from pfhubbenchmarks_tpu.solve import tree as jtr
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import make as make_torch
from pfhubbenchmarks_tpu_torch.interop import (solver_config_from_dict,
                                               state_from_numpy,
                                               time_config_from_dict)
from pfhubbenchmarks_tpu_torch.solve import tree as tr
from pfhubbenchmarks_tpu_torch.solve.krylov import fgmres


def _cast(pair, dtype):
    return tuple(a.astype(dtype) for a in pair)


def test_jax_fgmres_in_f64_takes_the_port_count():
    pj = make_jax(nx=24, ny=24)
    pj = dataclasses.replace(pj, solver=dataclasses.replace(
        pj.solver, gmg_min_cells=6, gmg_dense_coarse_max_dofs=0))
    w1 = jax_timeloop.run(pj, max_steps=1, verbose=False).state
    dt = 0.02
    s = pj.solver
    kw = dict(rtol=s.krylov_rtol, maxiter=s.krylov_max_iters,
              restart=s.gmres_restart,
              atol=max(s.krylov_atol, s.krylov_atol_frac * s.newton_atol))

    # the JAX package's operator and V-cycle at the step's initial guess
    F = pj.residual()(w1, w1, dt)
    Minv = pj.precond_builder()(w1, w1, dt)          # f32 in and out
    w1_32 = _cast(w1, jnp.float32)
    _, jv32 = jax.linearize(
        lambda u: pj.residual_lowp()(u, w1_32, jnp.float32(dt)), w1_32)
    b64 = jtr.neg(F)
    bnorm = float(jtr.norm(b64))
    j32 = jax.jit(lambda b: jax_krylov.fgmres(jv32, b, Minv=Minv, **kw))(
        _cast(b64, jnp.float32))
    j64 = jax.jit(lambda b: jax_krylov.fgmres(
        lambda v: _cast(jv32(_cast(v, jnp.float32)), jnp.float64), b,
        Minv=lambda r: _cast(Minv(r), jnp.float64), **kw))(b64)

    # the port's FGMRES, operator and V-cycle at the same state
    pt = make_torch(nx=24, ny=24,
                    solver=solver_config_from_dict(dataclasses.asdict(s)),
                    time=time_config_from_dict(dataclasses.asdict(pj.time)))
    wt = state_from_numpy(tuple(np.asarray(a) for a in w1), "cpu")
    wt32 = tr.cast(wt, torch.float32)
    port = fgmres(pt.lowp_jvp_factory("cpu")(wt32, wt32, float(np.float32(dt))),
                  tr.cast(tr.neg(pt.residual("cpu")(wt, wt, dt)), torch.float32),
                  pt.precond_builder("cpu")(wt, wt, dt), **kw)

    assert port.converged and bool(j64.converged) and bool(j32.converged)
    tol = max(kw["rtol"] * bnorm, kw["atol"])
    for res in (port.res_norm, float(j64.res_norm)):
        assert res <= tol * 1.0001
    assert int(j64.iters) == port.iters
    assert int(j32.iters) > port.iters
