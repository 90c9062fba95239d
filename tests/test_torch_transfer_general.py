"""The port's equal odd-ratio transfers (kernel H's plain versions,
``ops/transfer.py``; the factories of ``solve/transfer.py``) against the
JAX package, on seeded numpy inputs, in f64:

- prolongation, restriction and state injection against
  ``solve/transfer.py``'s ``*_general`` (and ``*_any`` for the dyadic
  70 -> 35 pair), for bench3's 70 -> 35 -> 7 ratios 2 and 5
  (tests/test_transfer_general.py's case), one R = 3 and one R = 7 pair:
  prolongation and injection exactly, restriction (a gather against
  ``jax.linear_transpose``) to rel 1e-14;
- against the TPU kernels' separable matmul form,
  ``ops/transfer_mats.py``'s ``prolong_gen_mm`` / ``restrict_gen_mm`` /
  ``inject_gen_mm`` (rel 1e-13);
- the adjoint identity <P x, y> = <x, R y> (rel 1e-13);
- the output-grid Dirichlet masks of prolongation and restriction;
- the f32 plain versions against the JAX package's f32 transfers at the f32
  tolerance of tests/test_pallas_vcycle.py (rtol 2e-4, atol 2e-5);
- unequal per-axis ratios, even ratios above 2 and periodic pairs raise
  "not yet ported"; the kernel wrappers refuse CPU tensors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.fem.grid import CrossedTriGrid as JaxGrid
from pfhubbenchmarks_tpu.ops import transfer_mats as tm
from pfhubbenchmarks_tpu.solve import transfer as jtransfer
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import transfer as kt
from pfhubbenchmarks_tpu_torch.solve import transfer as ttransfer

F = 2
PAIRS = [(70, 35), (35, 7), (21, 7), (35, 5)]


def _grids(nf, nc):
    L = 960.0 * nf / 350
    return (CrossedTriGrid(nc, nc, L, L), CrossedTriGrid(nf, nf, L, L),
            JaxGrid(nc, nc, L, L, pad_to=(1, 1)), JaxGrid(nf, nf, L, L, pad_to=(1, 1)))


def _pair(g, rng, dtype=np.float64):
    return tuple(rng.standard_normal((F,) + s).astype(dtype)
                 for s in (g.vshape, g.mshape))


def _j(p):
    return tuple(jnp.asarray(a) for a in p)


def _t(p, dtype=torch.float64):
    return state_from_numpy(p, "cpu", dtype)


def _close(got, ref, rel):
    for a, b in zip(state_to_numpy(got) if isinstance(got[0], torch.Tensor)
                    else got, ref):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1.0)


@pytest.mark.parametrize("nf,nc", PAIRS)
def test_general_transfers_match_jax_f64(nf, nc):
    coarse, fine, jc, jf = _grids(nf, nc)
    rng = np.random.default_rng(nf + nc)
    wc, wf = _pair(coarse, rng), _pair(fine, rng)
    general = nf != 2 * nc
    jfns = ((jtransfer.prolong_general, jtransfer.restrict_general,
             jtransfer.inject_state_general) if general
            else (jtransfer.prolong_any, jtransfer.restrict_any,
                  jtransfer.inject_any))
    tfns = (ttransfer.prolong_any, ttransfer.restrict_any, ttransfer.inject_any)
    srcs = (wc, wf, wf)
    if general:   # the *_general factories are the *_any ones on these pairs
        for f_any, f_gen, src in zip(tfns, (ttransfer.prolong_general,
                                            ttransfer.restrict_general,
                                            ttransfer.inject_state_general), srcs):
            _close(f_any(coarse, fine)(_t(src)),
                   state_to_numpy(f_gen(coarse, fine)(_t(src))), 0.0)
    for tfn, jfn, src, rel in zip(tfns, jfns, srcs, (0.0, 1e-14, 0.0)):
        _close(tfn(coarse, fine)(_t(src)), jfn(jc, jf)(_j(src)), rel)


@pytest.mark.parametrize("nf,nc", [p for p in PAIRS if p[0] != 2 * p[1]])
def test_general_transfers_match_transfer_mats(nf, nc):
    coarse, fine, jc, jf = _grids(nf, nc)
    rng = np.random.default_rng(3 * nf + nc)
    wc, wf = _pair(coarse, rng), _pair(fine, rng)
    m = tm.build_general_mats(jc, jf, dtype=np.float64)
    _close(kt.prolong(_t(wc), coarse, fine), tm.prolong_gen_mm(m, _j(wc)), 1e-13)
    _close(kt.restrict(_t(wf), coarse, fine), tm.restrict_gen_mm(m, _j(wf)), 1e-13)
    _close(kt.inject(_t(wf), coarse, fine), tm.inject_gen_mm(m, _j(wf)), 0.0)


@pytest.mark.parametrize("nf,nc", PAIRS)
def test_general_restriction_is_the_adjoint(nf, nc):
    coarse, fine, _, _ = _grids(nf, nc)
    rng = np.random.default_rng(5 * nf + nc)
    x, y = _t(_pair(coarse, rng)), _t(_pair(fine, rng))
    lhs = sum(float((a * b).sum()) for a, b in zip(kt.prolong(x, coarse, fine), y))
    rhs = sum(float((a * b).sum()) for a, b in zip(x, kt.restrict(y, coarse, fine)))
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


@pytest.mark.parametrize("op", ["restrict", "prolong", "prolong+="])
def test_general_masks(op):
    coarse, fine, jc, jf = _grids(35, 7)
    rng = np.random.default_rng(21)
    dst = fine if op.startswith("prolong") else coarse
    mask = (rng.random((F,) + dst.vshape) < 0.2).astype(np.float64)
    if op == "restrict":
        wf = _pair(fine, rng)
        got = kt.restrict(_t(wf), coarse, fine, torch.as_tensor(mask))
        ref = jtransfer.restrict_general(jc, jf)(_j(wf))
    else:
        wc = _pair(coarse, rng)
        ref = jtransfer.prolong_general(jc, jf)(_j(wc))
        if op == "prolong":
            got = kt.prolong(_t(wc), coarse, fine, mask=torch.as_tensor(mask))
        else:
            base = _pair(fine, rng)
            got = kt.prolong(_t(wc), coarse, fine, out=_t(base),
                             mask=torch.as_tensor(mask))
            got = tuple(g - torch.as_tensor(b) for g, b in zip(got, base))
    ref = (np.where(mask != 0, 0.0, np.asarray(ref[0])), np.asarray(ref[1]))
    _close(got, ref, 1e-14)


@pytest.mark.parametrize("nf,nc", [(35, 7), (21, 7)])
def test_general_transfers_f32_match_jax_f32(nf, nc):
    coarse, fine, jc, jf = _grids(nf, nc)
    rng = np.random.default_rng(nf * nc)
    wc, wf = _pair(coarse, rng, np.float32), _pair(fine, rng, np.float32)
    for got, ref in ((kt.prolong(_t(wc, torch.float32), coarse, fine),
                      jtransfer.prolong_general(jc, jf)(_j(wc))),
                     (kt.restrict(_t(wf, torch.float32), coarse, fine),
                      jtransfer.restrict_general(jc, jf)(_j(wf)))):
        assert all(t.dtype == torch.float32 for t in got)
        for a, b in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5)


def test_unported_pairs_raise():
    g = CrossedTriGrid(12, 12, 1.0, 1.0)
    for coarse in (CrossedTriGrid(4, 6, 1.0, 1.0),     # ratios 3 and 2
                   CrossedTriGrid(3, 3, 1.0, 1.0)):    # ratio 4
        with pytest.raises(NotImplementedError, match="not yet ported"):
            ttransfer.inject_any(coarse, g)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            kt.transfer_ops(coarse, g, "plain")
    per = dataclasses.replace(g, periodic=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        ttransfer.prolong_any(dataclasses.replace(per, nx=4, ny=4), per)


def test_kernel_wrappers_refuse_cpu_tensors():
    coarse, fine, _, _ = _grids(35, 7)
    rng = np.random.default_rng(1)
    wc = _t(_pair(coarse, rng, np.float32), torch.float32)
    wf = _t(_pair(fine, rng, np.float32), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kt.prolong_general_kernel(wc, coarse, fine)
    with pytest.raises(ValueError, match="CUDA"):
        kt.restrict_general_kernel(wf, coarse, fine)
    # the parameter block is GenWeights: 2 x 7 x 7 x 5 weights, 2 x 7 edge
    # weights, 1 - frac rounded in f32
    params = kt._general_params(5)
    assert params.dtype == np.float32 and params.size == 2 * 245 + 14
    frac = params[490:495]
    np.testing.assert_array_equal(params[497:502], np.float32(1.0) - frac)
