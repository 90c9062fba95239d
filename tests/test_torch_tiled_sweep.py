"""TS, the sweep of the tile kernels (ops/fem_tile.py: block-Jacobi and
A z in the seam form), and the tiled sweep loop (ops/lmr.py), in their
plain versions against the JAX package's grid-form tiled sweep in
interpret mode, on seeded numpy inputs at bench2 8^2, block 4:

- one sweep (TS, then the step) against ``make_grid_tiled_lmr_sweep``,
  coupled (rtol 3e-4, atol 5e-5, as tests/test_pallas_tiled_grid.py);
- with the field groups, against the dense block planes (rtol 1e-5, atol
  1e-6: the cross-group planes are exactly 0), and two calls give the same
  bits;
- a seam-form J.v's level sweep loop is TS and the step per sweep.

On this CPU the wrappers run these plain versions; ``chip_smoke.py`` holds
the CUDA kernel against them on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu.ops.pallas_tiled_grid import make_grid_tiled_lmr_sweep
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks import bench2
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import chac_jvp, fem_tile, lmr


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _tile_jv(pt, form, block_rows, split):
    """The port's bench2 tile J.v with the plain version's row block."""
    p = bench2.Bench2Params()
    k = bench2.kernel_constants(p)
    return fem_tile.make_tile_jvp(
        pt.grid, bench2.make_terms_tangent(p, 4, split), pt.n_fields,
        form=form, symbol="pfh_chac_tile",
        constants=tuple(k[n] for n in chac_jvp.CONSTANTS), device="cpu",
        variant=(4, int(split)), block_rows=block_rows)


@pytest.fixture(scope="module")
def sweep_case():
    pj = make_jax2(nx=8, ny=8)
    pt = bench2.make(nx=8, ny=8)
    g, F = pj.grid, pj.n_fields
    w = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(3)
    r = tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
    pinv = {split: tuple(np.asarray(P) for P in jax_bj(
        g, pj.terms_precond if split else pj.terms, F, dtype=jnp.float32)(
            _j(w), _j(w), 0.05).pinv_planes) for split in (False, True)}
    ts = {split: _tile_jv(pt, "seam", 4, split).tile_sweep
          for split in (False, True)}
    return pj, w, r, pinv, ts


def _one_sweep(ts, w, r, pinv, groups, alpha_groups):
    x = tuple(torch.zeros_like(t) for t in _t(r))
    rr = _t(r)
    z, az = ts(_t(w), _t(w), 0.05, rr, _t(pinv), groups)
    lmr.lmr_step_plain(x, rr, z, az, alpha_groups)
    return x + rr


def test_tile_sweep_matches_make_grid_tiled_lmr_sweep(sweep_case):
    pj, w, r, pinv, ts = sweep_case
    prep, sweep_j = make_grid_tiled_lmr_sweep(pj.grid, pj.terms, pj.n_fields,
                                              block_rows=4, interpret=True)
    x0 = tuple(jnp.zeros_like(a) for a in _j(r))
    xj, rj = sweep_j(x0, _j(r), 1, prep(_j(w), _j(w), _j(pinv[False])), 0.05)
    got = _one_sweep(ts[False], w, r, pinv[False], None, None)
    _close(state_to_numpy(got), xj + rj, 3e-4, 5e-5)


def test_tile_sweep_field_groups(sweep_case):
    """With the field groups TS reads only the in-group planes: the split
    operator's sweep equals the one with the dense planes, whose
    cross-group planes are exactly 0."""
    pj, w, r, pinv, ts = sweep_case
    groups = pj.field_groups
    grouped = _one_sweep(ts[True], w, r, pinv[True], groups, None)
    dense = _one_sweep(ts[True], w, r, pinv[True], None, None)
    _close(state_to_numpy(grouped), state_to_numpy(dense), 1e-5, 1e-6)
    z1 = ts[True](_t(w), _t(w), 0.05, _t(r), _t(pinv[True]), groups)
    z2 = ts[True](_t(w), _t(w), 0.05, _t(r), _t(pinv[True]), groups)
    assert all(torch.equal(x, y) for x, y in zip(z1[0] + z1[1], z2[0] + z2[1]))


def test_level_sweep_loop_takes_the_tiled_loop(sweep_case):
    """A seam-form J.v carries TS, and the level's sweep loop is then TS and
    the step (C) per sweep, with one step length per group."""
    pj, w, r, pinv, ts = sweep_case
    pt = bench2.make(nx=8, ny=8)
    jv = pt.kernel_jvp(pt.grid, "cpu", split=True, form="seam")
    groups = pt.field_groups
    sweep = lmr.make_level_sweep_loop(jv, 2, groups)
    assert sweep.name == "tile_sweep_loop"
    x = tuple(torch.zeros_like(t) for t in _t(r))
    got = sweep(x, _t(r), _t(w), _t(w), 0.05, *_t(pinv[True]))
    xe, re = tuple(torch.zeros_like(t) for t in _t(r)), _t(r)
    for _ in range(2):
        z, az = jv.tile_sweep(_t(w), _t(w), 0.05, re, _t(pinv[True]), groups)
        lmr.lmr_step_plain(xe, re, z, az, groups)
    assert all(torch.equal(a, b) for a, b in zip(got[0] + got[1], xe + re))
    gather = pt.kernel_jvp(pt.grid, "cpu", split=True)
    assert lmr.make_level_sweep_loop(gather, 2, groups).name == "lmr_sweep_loop"
