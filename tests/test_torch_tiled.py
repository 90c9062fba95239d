"""The plain versions of the tile kernels (ops/fem_tile.py: T10, T12, TS)
against the JAX package's tiled kernels in interpret mode, on seeded numpy
inputs, and the routing of the tiled configuration:

- ``choose_block_rows`` equals the JAX package's;
- T10 against ``pallas_tiled.make_tiled_jvp`` at bench2 16^2, block 4
  (rtol 3e-4, atol 3e-5, as tests/test_pallas_tiled.py);
- T12 against ``pallas_tiled_grid.make_grid_tiled_jvp`` at bench1 24^2,
  block 8 (rtol 2e-4, atol 5e-5, as tests/test_pallas_tiled_grid.py), and
  against the port's untiled J.v, in the J.v and b - J.v forms;
- two calls give the same bits;
- which levels the tiled configuration routes to the tile kernels.

TS, the tile kernels' sweep, is held in tests/test_torch_tiled_sweep.py (each
file stays near a minute on a CPU: interpret-mode Pallas at six fields
traces slowly).

On this CPU the wrappers run these plain versions; ``chip_smoke.py`` holds
the CUDA kernels against them on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax1
from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu.ops.pallas_tiled import (choose_block_rows as
                                                  jax_block_rows,
                                                  make_tiled_jvp)
from pfhubbenchmarks_tpu.ops.pallas_tiled_grid import make_grid_tiled_jvp
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import ch_jvp, chac_jvp, fem_tile


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def _tile_jv(pt, form, block_rows, split=None):
    """The tile J.v of the port's bench1 (``split`` None) or bench2 with the
    plain version's row block ``block_rows``."""
    if split is None:
        p = bench1.Bench1Params()
        tangent = bench1.make_terms(p)[1]
        k = bench1.kernel_constants(p)
        sym, names, variant = "pfh_ch_tile", ch_jvp.CONSTANTS, ()
    else:
        p = bench2.Bench2Params()
        tangent = bench2.make_terms_tangent(p, 4, split)
        k = bench2.kernel_constants(p)
        sym, names, variant = "pfh_chac_tile", chac_jvp.CONSTANTS, (4, int(split))
    return fem_tile.make_tile_jvp(pt.grid, tangent, pt.n_fields, form=form,
                                  symbol=sym, constants=tuple(k[n] for n in names),
                                  device="cpu", variant=variant,
                                  block_rows=block_rows)


def _inputs(pj, seed):
    """(w, v, b): the JAX problem's f32 IC and two seeded random pairs."""
    w = tuple(np.asarray(a, np.float32) for a in pj.initial_state())
    rng = np.random.default_rng(seed)
    v, b = (tuple(rng.standard_normal(a.shape).astype(np.float32) for a in w)
            for _ in range(2))
    return w, v, b


def test_choose_block_rows_is_the_jax_packages():
    for ny in (7, 8, 12, 16, 24, 25, 32, 35, 40, 50, 64, 100, 175, 350):
        assert fem_tile.choose_block_rows(ny) == jax_block_rows(ny)
    assert [fem_tile.multi_block(bench1.make(nx=n, ny=n).grid)
            for n in (25, 32, 40, 50, 100)] == [False, False, True, True, True]


def test_recompute_plain_matches_make_tiled_jvp():
    pj = make_jax2(nx=16, ny=16)
    pt = bench2.make(nx=16, ny=16)
    g, F = pj.grid, pj.n_fields
    w, v, _ = _inputs(pj, 2)
    prep, jv_j = make_tiled_jvp(g, pj.terms, F, dtype=jnp.float32,
                                block_rows=4, interpret=True)
    want = jv_j(_j(v), prep(_j(w), _j(w)), jnp.float32(0.05))
    jv = _tile_jv(pt, "recompute", 4, split=False)
    got = jv(_t(w), _t(w), 0.05, _t(v))
    _close(state_to_numpy(got), want, 3e-4, 3e-5)


@pytest.fixture(scope="module")
def seam_case():
    pj = make_jax1(nx=24, ny=24)
    pt = bench1.make(nx=24, ny=24)
    w, v, b = _inputs(pj, 1)
    jv = _tile_jv(pt, "seam", 8)
    return pj, pt, w, v, b, jv


def test_seam_plain_matches_make_grid_tiled_jvp(seam_case):
    pj, _, w, v, _, jv = seam_case
    prep, jv_j = make_grid_tiled_jvp(pj.grid, pj.terms, pj.n_fields,
                                     block_rows=8, interpret=True)
    want = jv_j(_j(v), prep(_j(w), _j(w)), 0.3)
    _close(state_to_numpy(jv(_t(w), _t(w), 0.3, _t(v))), want, 2e-4, 5e-5)


@pytest.mark.parametrize("form", ["recompute", "seam"])
@pytest.mark.parametrize("with_b", [False, True])
def test_tile_plain_matches_untiled_jvp(seam_case, form, with_b):
    _, pt, w, v, b, jv_seam = seam_case
    jv = (jv_seam if form == "seam" else
          pt.kernel_jvp(pt.grid, "cpu", form="recompute"))
    gather = pt.kernel_jvp(pt.grid, "cpu")
    bb = _t(b) if with_b else None
    got = jv(_t(w), _t(w), 0.3, _t(v), b=bb)
    _close(state_to_numpy(got),
           state_to_numpy(gather(_t(w), _t(w), 0.3, _t(v), b=bb)), 2e-4, 5e-5)
    again = jv(_t(w), _t(w), 0.3, _t(v), b=bb)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def _tiled(problem):
    return dataclasses.replace(problem, solver=dataclasses.replace(
        problem.solver, tiled_grid_kernels=True))


@pytest.mark.parametrize("make,levels,routed", [
    (bench1.make, [100, 50, 25], [True, True, False]),
    (bench3.make, [350, 175, 35, 7], [True, True, True, False]),
    (bench2.make, [100, 50, 25], [True, True, False]),
])
def test_tiled_configuration_routes_the_levels(make, levels, routed):
    p = make()
    build = _tiled(p).precond_builder("cpu")
    assert [g.nx for g in build.grids] == levels
    assert build.tiled_levels == routed
    assert not any(p.precond_builder("cpu").tiled_levels)


def test_bench6_has_no_tile_kernels():
    p = bench6.make(nx=40, ny=40)
    with pytest.raises(NotImplementedError, match="no tile kernels"):
        _tiled(p).lowp_jvp_factory("cpu")
