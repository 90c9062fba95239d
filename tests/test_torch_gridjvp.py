"""Kernel Q's plain version (``ops/gridjvp.py``: the row-block slabs and
their fold; TPU row 19, tools/probes/gridjvp_probe.py) against the JAX
package at bench3 70^2 with BR = 14 (5 row blocks), on seeded numpy inputs:

- case a (BM3's pointwise tangent) against ``jax.jvp`` of the JAX
  ``make_residual`` in f32; case c runs case a's body;
- case b (identity physics) against the JAX residual of the identity terms,
  which is linear, so it is J z.

Tolerances: rtol 2e-4 with atol 2e-5 (tests/test_pallas_vcycle.py's f32
pair) at dt = 1, and at the probe's dt = 0.01, whose 1/dt terms make entries
of ~2e4 that cancel, atol 2e-5 x max|ref| (chip_smoke.py's TOL_F32). Also
the seam rows: each block's slab holds only its own cells' part, and the
fold adds two slabs there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import make as make_torch
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.gridjvp import body_case, make_gridjvp, probe

N, BR = 70, 14


@pytest.fixture(scope="module")
def case():
    pj, pt = make_jax(nx=N, ny=N), make_torch(nx=N, ny=N)
    w = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(0)
    z = tuple(rng.normal(size=a.shape).astype(np.float32) for a in w)
    q = make_gridjvp(pt.grid, pt.kernel_phys(), device="cpu", br=BR)
    return pj, w, z, q


def _tol(dt, ref):
    scale = 1.0 if dt == 1.0 else max(float(np.abs(ref).max()), 1.0)
    return dict(rtol=2e-4, atol=2e-5 * scale)


def _t(pair):
    return tuple(torch.tensor(a) for a in pair)


@pytest.mark.parametrize("dt", [1.0, 0.01])
@pytest.mark.parametrize("name", ["a", "c"])
def test_case_a_matches_jax_jvp(case, name, dt):
    pj, w, z, q = case
    assert q.n_blocks == N // BR
    res32 = jax_residual(pj.grid, pj.terms, 2, dtype=jnp.float32)
    wj = tuple(map(jnp.asarray, w))
    _, ref = jax.jvp(lambda u: res32(u, wj, jnp.float32(dt)), (wj,),
                     (tuple(map(jnp.asarray, z)),))
    _lib.reset_launches()
    got = q.jv(name, _t(w), dt, _t(z))
    assert _lib.LAUNCHES["gridjvp_probe"] == 0  # CPU tensors: plain versions
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, **_tol(dt, b))


@pytest.mark.parametrize("dt", [1.0, 0.01])
def test_case_b_matches_jax_identity_residual(case, dt):
    pj, w, z, q = case

    def identity_terms(ctx):
        return list(ctx.u), [tuple(d) for d in ctx.du]

    zj = tuple(map(jnp.asarray, z))
    ref = jax_residual(pj.grid, identity_terms, 2, dtype=jnp.float32)(
        zj, zj, jnp.float32(dt))
    for a, b in zip(q.jv("b", _t(w), dt, _t(z)), ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, **_tol(1.0, b))


def test_slabs_hold_their_own_cells_and_the_fold_adds_seams(case):
    pj, w, z, q = case
    slabs, _ = q("b", _t(w), 1.0, _t(z))
    assert slabs.shape == (2, q.n_blocks * (BR + 1), N + 1)
    ov = q.fold(slabs)
    # a seam row (cell row 14 = block 1's first vertex row) is block 0's
    # last slab row plus block 1's first
    torch.testing.assert_close(ov[:, BR], slabs[:, BR] + slabs[:, BR + 1],
                               rtol=0, atol=0)
    # an inner row belongs to one block
    torch.testing.assert_close(ov[:, BR + 3], slabs[:, BR + 1 + 3], rtol=0, atol=0)
    with pytest.raises(ValueError):
        body_case("d")


def test_probe_path_on_cpu():
    out = probe("c", device="cpu", nx=N, br=BR, timing=False)
    assert out["body"] == "a" and out["blocks"] == N // BR
    assert out["kernel G"]["ok"] and out["torch.func.jvp"]["ok"]
    assert "device_us" not in out
