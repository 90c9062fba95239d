"""The transfer plans of ops/transfer.py (``TransferPlan``: kernel D for a
dyadic pair, H for an equal odd ratio, built once per level pair) on the
CPU, where a plan runs its plain version:

- construction refuses a pair that is not nested, unequal per-axis ratios,
  a periodic or padded grid, a mask of the wrong shape, a mask on an
  injection and an unknown op;
- a call on the card checks its tensors: a stand-in CUDA tensor (a CPU
  tensor that reports a CUDA device) of the wrong shape, dtype, contiguity
  or device, or beside a mask on another device, is refused before any
  launch; CPU tensors are refused by ``.kernel``;
- on CPU tensors a plan gives exactly the plain versions' output (prolong,
  prolong with ``out``, restrict, inject; with and without masks; R = 2, 3,
  5, 7), and so do the public functions built on it;
- the level steps and chains, which now hold plans, give exactly the
  outputs of their sweeps followed by the plain transfers picked by
  ``transfer_ops``, as before the plans (bench1 16/8/4, bench6 16/8/4 with
  its Dirichlet masks, a bench3-like 25/5 pair of ratio 5);
- a numpy transliteration of kernel H's restriction as the card runs it
  (csrc/transfer_general.cu: one CTA per field, coarse row and column chunk,
  the fine rows of the strip staged first, then one chain per coarse node in
  transfer.cuh's order, every product and sum rounded in f32) gives the
  plain version's bits, and reads nothing outside its staged strip.

The plain versions themselves are held against the JAX package's
solve/transfer.py by tests/test_torch_ops.py, test_torch_transfer_general.py
and test_torch_bench6.py.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench3, bench6
from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                        make_ascend_level,
                                                        make_descend_chain,
                                                        make_descend_level)
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

CSRC = Path(kt.__file__).resolve().parent.parent / "csrc"
DT = 0.25


def _grid(n, m=None, **kw):
    return CrossedTriGrid(n, n if m is None else m, 1.0, 1.0, **kw)


def _pair(g, F, rng, dtype=torch.float32):
    return tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=dtype)
                 for s in (g.vshape, g.mshape))


def _mask(g, F, rng):
    return torch.tensor((rng.random((F,) + g.vshape) < 0.3).astype(np.float32))


def _equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# construction and per-call checks
# ---------------------------------------------------------------------------

def test_construction_refuses_unported_or_wrong_inputs():
    fine = _grid(12)
    with pytest.raises(ValueError, match="not nested"):
        kt.TransferPlan(_grid(5), fine, 2, "restrict")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        kt.TransferPlan(_grid(6, 4), fine, 2, "restrict")      # ratios 2, 3
    with pytest.raises(NotImplementedError, match="not yet ported"):
        kt.TransferPlan(_grid(3), fine, 2, "prolong")          # ratio 4
    per = _grid(12, periodic=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        kt.TransferPlan(_grid(6, periodic=True), per, 2, "prolong")
    with pytest.raises(NotImplementedError, match="unpadded"):
        kt.TransferPlan(_grid(6), _grid(12, pad_to=(8, 8)), 2, "restrict")
    with pytest.raises(NotImplementedError, match="unpadded"):
        kt.TransferPlan(_grid(4, pad_to=(8, 8)), fine, 2, "inject")
    coarse = _grid(6)
    with pytest.raises(ValueError, match="mask"):   # a coarse mask on prolong
        kt.TransferPlan(coarse, fine, 2, "prolong",
                        torch.zeros((2,) + coarse.vshape))
    with pytest.raises(ValueError, match="mask"):   # the wrong field count
        kt.TransferPlan(coarse, fine, 2, "restrict",
                        torch.zeros((3,) + coarse.vshape))
    with pytest.raises(ValueError, match="no mask"):
        kt.TransferPlan(coarse, fine, 2, "inject",
                        torch.zeros((2,) + coarse.vshape))
    with pytest.raises(ValueError, match="transfer op"):
        kt.TransferPlan(coarse, fine, 2, "interpolate")


class _OnCard:
    """A CPU tensor that reports itself as a CUDA tensor on ``device``: what
    a plan's per-call check reads, so the refusals can be tested without a
    card."""

    def __init__(self, t, device=0):
        self.t, self.dev = t, device
        self.is_cuda, self.is_cpu = True, False
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda", device)

    def is_contiguous(self):
        return self.t.is_contiguous()

    def get_device(self):
        return self.dev


@pytest.mark.parametrize("nc,nf", [(6, 12), (4, 20)])
def test_call_checks_refuse_before_launch(nc, nf):
    coarse, fine = _grid(nc), _grid(nf)
    rng = np.random.default_rng(nc)
    F = 2
    plan = kt.TransferPlan(coarse, fine, F, "restrict")
    good = tuple(_OnCard(t) for t in _pair(fine, F, rng))
    assert plan.check(good) == 0
    with pytest.raises(ValueError, match="CUDA"):
        plan.kernel(_pair(fine, F, rng))
    with pytest.raises(ValueError, match="shape"):
        plan.check((good[0], _OnCard(_pair(coarse, F, rng)[1])))
    with pytest.raises(ValueError, match="shape"):     # another field count
        plan.check(tuple(_OnCard(t) for t in _pair(fine, 3, rng)))
    with pytest.raises(ValueError, match="dtype"):
        plan.check(tuple(_OnCard(t) for t in _pair(fine, F, rng,
                                                   torch.float64)))
    v = torch.zeros((F,) + fine.vshape[::-1]).transpose(1, 2)
    assert v.shape == (F,) + fine.vshape
    with pytest.raises(ValueError, match="non-contiguous"):
        plan.check((_OnCard(v), good[1]))
    with pytest.raises(ValueError, match="cuda:1"):
        plan.check((good[0], _OnCard(good[1].t, device=1)))
    with pytest.raises(ValueError, match="takes no out"):
        plan.check(good, good)
    prolong = kt.TransferPlan(coarse, fine, F, "prolong",
                              torch.zeros((F,) + fine.vshape))
    src = tuple(_OnCard(t) for t in _pair(coarse, F, rng))
    with pytest.raises(ValueError, match="mask on cpu"):
        prolong.check(src)
    with pytest.raises(ValueError, match="shape"):     # out of the coarse grid
        prolong.check(src, src)


# ---------------------------------------------------------------------------
# CPU tensors: exactly the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nc,nf,F", [(4, 8, 2), (5, 10, 3), (3, 9, 2),
                                     (5, 25, 1), (2, 14, 2)])
@pytest.mark.parametrize("masked", [False, True])
def test_plans_on_cpu_are_the_plain_versions(nc, nf, F, masked):
    coarse, fine = _grid(nc), _grid(nf, nf)
    R = nf // nc
    rng = np.random.default_rng(nf * 10 + nc + masked)
    mf, mc = ((_mask(fine, F, rng), _mask(coarse, F, rng)) if masked
              else (None, None))
    pl, rs = ((kt.prolong_plain, kt.restrict_plain) if R == 2 else
              (kt.prolong_general_plain, kt.restrict_general_plain))
    xc, rf, base = _pair(coarse, F, rng), _pair(fine, F, rng), _pair(fine, F, rng)

    P = kt.TransferPlan(coarse, fine, F, "prolong", mf)
    _equal(P(xc), pl(xc, coarse, fine, mf))
    _equal(P(xc), kt.prolong(xc, coarse, fine, mask=mf))
    out = tuple(t.clone() for t in base)
    assert P(xc, out) is out
    _equal(out, tuple(b + p for b, p in zip(base, pl(xc, coarse, fine, mf))))

    Rt = kt.TransferPlan(coarse, fine, F, "restrict", mc)
    _equal(Rt(rf), rs(rf, coarse, fine, mc))
    _equal(Rt(rf), kt.restrict(rf, coarse, fine, mc))
    with pytest.raises(ValueError, match="takes no out"):
        Rt(rf, tuple(t.clone() for t in xc))

    inj = kt.TransferPlan(coarse, fine, F, "inject")
    _equal(inj(rf), (kt.inject_plain if R == 2 else kt.inject_general)(
        rf, coarse, fine))
    _equal(inj(rf), kt.inject(rf, coarse, fine))
    assert inj.kernel_name == ("transfer_dyadic" if R == 2 else
                               "transfer_general")


def test_plans_launch_nothing_on_cpu():
    coarse, fine = _grid(5), _grid(25)
    rng = np.random.default_rng(3)
    _lib.reset_launches()
    kt.TransferPlan(coarse, fine, 2, "restrict")(_pair(fine, 2, rng))
    kt.TransferPlan(_grid(10), _grid(20), 2, "prolong")(_pair(_grid(10), 2, rng))
    assert all(n == 0 for n in _lib.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the level steps and chains hold plans
# ---------------------------------------------------------------------------

def _level_setup(problem, grids, rule, seed):
    F = problem.n_fields
    grids = [dataclasses.replace(g, rule_name=rule) for g in grids]
    rng = np.random.default_rng(seed)
    jvs, ws, pinvs, masks = [], [], [], []
    for g in grids:
        v, m = g.interpolate(problem.ic_fns)
        w = tuple(torch.tensor(a + 0.01 * rng.standard_normal(a.shape),
                               dtype=torch.float32) for a in (v, m))
        bcs = problem.dirichlet_for(g)
        for bc in bcs:
            w = (bc.apply_value(w[0]), w[1])
        jvs.append(problem.kernel_jvp(g, "cpu", bcs))
        ws.append(w)
        pinvs.append(make_block_jacobi(g, problem.terms, F, device="cpu",
                                       dirichlet=bcs)(w, w, DT).pinv_planes)
        m = bc_mask(g, bcs, F)
        masks.append(None if m is None else torch.as_tensor(m))
    return grids, jvs, ws, pinvs, masks, rng


def _old_descend(fine, coarse, jv, nu, mask_c, b, w, pinv):
    """A descent step as the step composed it before the plans: the sweeps,
    then the plain restriction that ``transfer_ops`` picks."""
    x = tuple(torch.zeros_like(t) for t in b)
    r = tuple(t.clone() for t in b)
    lmr.make_level_sweep_loop(jv, nu).plain(x, r, w, w, DT, *pinv)
    return x, kt.transfer_ops(coarse, fine, "plain")[0](r, coarse, fine, mask_c)


def _old_ascend(fine, coarse, jv, nu, mask_f, b, x, xc, w, pinv):
    x = tuple(t.clone() for t in x)
    kt.transfer_ops(coarse, fine, "plain")[1](xc, coarse, fine, x, mask_f)
    r = jv.plain(w, w, DT, x, b=b)
    lmr.make_level_sweep_loop(jv, nu).plain(x, r, w, w, DT, *pinv)
    return x


@pytest.mark.parametrize("make,sizes,rule", [
    (bench1.make, (16, 8, 4), "dunavant2"),
    (bench6.make, (16, 8, 4), "dunavant2"),
    (bench3.make, (25, 5), "dunavant2")])
def test_level_steps_and_chains_with_plans_as_before(make, sizes, rule):
    problem = make(nx=sizes[0], ny=sizes[0])
    F = problem.n_fields
    hier = [dataclasses.replace(problem.grid, nx=n, ny=n) for n in sizes]
    grids, jvs, ws, pinvs, masks, rng = _level_setup(problem, hier, rule,
                                                     sizes[0] + len(sizes))
    nu_d, nu_a = 2, 3
    b0 = _pair(grids[0], F, rng)
    _lib.reset_launches()
    # one level step each way, on every pair
    for l, (fine, coarse) in enumerate(zip(grids[:-1], grids[1:])):
        b, xc = _pair(fine, F, rng), _pair(coarse, F, rng)
        d = make_descend_level(fine, coarse, jvs[l], nu=nu_d,
                               mask_coarse=masks[l + 1])
        x, bc = d(b, ws[l], ws[l], DT, pinvs[l])
        x_o, bc_o = _old_descend(fine, coarse, jvs[l], nu_d, masks[l + 1], b,
                                 ws[l], pinvs[l])
        _equal(x, x_o)
        _equal(bc, bc_o)
        a = make_ascend_level(fine, coarse, jvs[l], nu=nu_a,
                              mask_fine=masks[l])
        _equal(a(b, x, xc, ws[l], ws[l], DT, pinvs[l]),
               _old_ascend(fine, coarse, jvs[l], nu_a, masks[l], b, x, xc,
                           ws[l], pinvs[l]))
    # the chains
    descend = make_descend_chain(grids, jvs, nu=nu_d, masks=masks)
    ascend = make_ascend_chain(grids, jvs, nu=nu_a, masks=masks)
    xs, bs, bc = descend(b0, ws[:-1], ws[:-1], DT, pinvs[:-1])
    b, xs_o, bs_o = b0, [], []
    for l in range(len(grids) - 1):
        x, b = _old_descend(grids[l], grids[l + 1], jvs[l], nu_d, masks[l + 1],
                            b, ws[l], pinvs[l])
        xs_o.append(x)
        bs_o.append(b)
    for got, ref in zip(xs + bs + [bc], xs_o + bs_o[:-1] + [bs_o[-1]]):
        _equal(got, ref)
    xc = _pair(grids[-1], F, rng)
    z = ascend([b0] + bs, xs, xc, ws[:-1], ws[:-1], DT, pinvs[:-1])
    z_o = xc
    for l in range(len(grids) - 2, -1, -1):
        z_o = _old_ascend(grids[l], grids[l + 1], jvs[l], nu_a, masks[l],
                          ([b0] + bs)[l], xs[l], z_o, ws[l], pinvs[l])
    _equal(z, z_o)
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())


# ---------------------------------------------------------------------------
# kernel H's strip restriction, transliterated
# ---------------------------------------------------------------------------

def _cuda_constant(name):
    src = (CSRC / "transfer_general.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _strip_restrict(wf, coarse, fine, mask):
    """Kernel H's restriction in numpy, CTA by CTA and lane by lane, as
    restrict_general_kernel runs it; a strip entry that is not staged is
    NaN, and a read outside the strip raises."""
    R = fine.nx // coarse.nx
    nyc, nxc = coarse.ny, coarse.nx
    nyf, nxf = R * nyc, R * nxc
    kchunk = _cuda_constant("kChunk")
    kW, kH = R * (kchunk + 1), 2 * R
    p = kt._general_params(R)
    wv = p[: 245].reshape(7, 7, 5)
    wm = p[245: 490].reshape(7, 7, 5)
    frac, om = p[490: 497], p[497: 504]
    n_chunks = math.ceil((nxc + 1) / kchunk)
    chunk = math.ceil((nxc + 1) / n_chunks)
    vf, mf = (t.numpy() for t in wf)
    F = vf.shape[0]
    vc = np.full((F,) + coarse.vshape, np.nan, np.float32)
    mc = np.full((F,) + coarse.mshape, np.nan, np.float32)
    f32 = np.float32
    for f in range(F):
        for I in range(nyc + 1):
            for blk in range(n_chunks):
                J0 = blk * chunk
                nc = min(chunk, nxc + 1 - J0)
                y0, x0 = R * (I - 1), R * (J0 - 1)
                sv = np.full((kH, kW), np.nan, np.float32)
                sm = np.full((kH, kW), np.nan, np.float32)
                for s, plane, ny_p, nx_p in ((sv, vf, nyf + 1, nxf + 1),
                                             (sm, mf, nyf, nxf)):
                    for y in range(max(y0, 0), min(y0 + kH, ny_p)):
                        x = np.arange(max(x0, 0), min(x0 + R * (nc + 1), nx_p))
                        s[y - y0, x - x0] = plane[f, y, x]

                def rd(s, y, x):
                    if not (0 <= y - y0 < kH and 0 <= x - x0 < kW):
                        raise IndexError(f"read ({y}, {x}) outside the strip")
                    return s[y - y0, x - x0]

                def cell(S, ci, cj, acc):
                    for W, s in ((wv, sv), (wm, sm)):
                        for py in range(R):
                            for px in range(R):
                                acc = f32(acc + f32(W[py, px, S] * rd(
                                    s, R * ci + py, R * cj + px)))
                    return acc

                for lane in range(nc):          # warp 0: coarse vertices
                    J = J0 + lane
                    acc = f32(0.0)
                    if I < nyc and J < nxc:
                        acc = cell(0, I, J, acc)
                    if I < nyc and J > 0:
                        acc = cell(1, I, J - 1, acc)
                    if I > 0 and J < nxc:
                        acc = cell(2, I - 1, J, acc)
                    if I > 0 and J > 0:
                        acc = cell(3, I - 1, J - 1, acc)
                    if I == nyc:
                        if J < nxc:
                            for q in range(R):
                                acc = f32(acc + f32(om[q] * rd(sv, nyf, R * J + q)))
                        if J > 0:
                            for q in range(R):
                                acc = f32(acc + f32(frac[q] * rd(
                                    sv, nyf, R * (J - 1) + q)))
                    if J == nxc:
                        if I < nyc:
                            for q in range(R):
                                acc = f32(acc + f32(om[q] * rd(sv, R * I + q, nxf)))
                        if I > 0:
                            for q in range(R):
                                acc = f32(acc + f32(frac[q] * rd(
                                    sv, R * (I - 1) + q, nxf)))
                    if I == nyc and J == nxc:
                        acc = f32(acc + rd(sv, nyf, nxf))
                    if mask is not None and mask[f, I, J] != 0:
                        acc = f32(0.0)
                    vc[f, I, J] = acc
                for lane in range(nc):          # warp 1: coarse centres
                    j = J0 + lane
                    if I < nyc and j < nxc:
                        mc[f, I, j] = cell(4, I, j, f32(0.0))
    return torch.from_numpy(vc), torch.from_numpy(mc)


@pytest.mark.parametrize("nyc,nxc,R,F", [(5, 5, 5, 2), (2, 3, 7, 1),
                                         (3, 40, 3, 2), (4, 33, 3, 1)])
def test_strip_restriction_transliterated_gives_the_plain_bits(nyc, nxc, R, F):
    coarse, fine = _grid(nxc, nyc), _grid(R * nxc, R * nyc)
    rng = np.random.default_rng(R * 100 + nxc)
    wf = _pair(fine, F, rng)
    mask = _mask(coarse, F, rng) if F == 2 else None
    got = _strip_restrict(wf, coarse, fine,
                          None if mask is None else mask.numpy())
    _equal(got, kt.restrict_general_plain(wf, coarse, fine, mask))
