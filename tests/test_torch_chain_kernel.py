"""The chain kernels' CPU side (ops/vcycle_chain.py ``ChainPlan``: the
descend and ascend chains of a V-cycle, each one launch of
``vcycle_descend_chain`` / ``vcycle_ascend_chain`` on the card), with the
port's level steps and the JAX package as the oracles:

- the plan's per-level table (parameter block with dt, slots ``nb``, group
  starts, the Dirichlet masks of the sweeps and of the transfer, the pair's
  ratio and H's class tables) is what each level's launches take today:
  kernel L's and the level J.v's launchers, read from the calls of a
  recording stand-in for the library, and the pair's ``TransferPlan``;
- a plain interpreter that walks the same table, phase by phase as
  ``csrc/vcycle_chain.cuh`` runs them, gives the bits of the chains' plain
  versions (``torch.equal``): a bench1-like 3-level hierarchy, bench6 with
  its Dirichlet masks, bench2 with its field groups (F = 6), and a
  mixed-ratio hierarchy (ratios 2 and 5, so H's bodies run);
- the mixed-ratio chains against ``make_fused_descend_chain`` /
  ``make_fused_ascend_chain`` (TPU rows 7 and 8) in interpret mode, at the
  f32 tolerances of tests/test_pallas_vcycle.py (rtol 2e-4, atol 2e-5: the
  two sides sum in different orders);
- a chain whose levels run different point counts, physics or tile routes
  has no kernel, and on the CPU a chain launches nothing.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench3 import make as make_jax3
from pfhubbenchmarks_tpu.ops.pallas_vcycle import (make_fused_ascend_chain,
                                                   make_fused_descend_chain)
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (ChainPlan,
                                                        make_ascend_chain,
                                                        make_ascend_level,
                                                        make_descend_chain,
                                                        make_descend_level)
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
DT = 0.04
NU = dict(nu=2, nu_fine=1)

# name: (make, level sizes, level rule, field split)
CONFIGS = {
    "bench1": (bench1.make, (16, 8, 4), "dunavant2", False),
    "bench6": (bench6.make, (16, 8, 4), "dunavant2", False),
    "bench2": (bench2.make, (8, 4, 2), "dunavant1", True),
    "mixed": (bench3.make, (10, 5, 1), "dunavant2", False),
}


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _setup(name, seed=5):
    """The problem, its levels at the level rule, their J.v, Dirichlet
    masks and field groups, per-level states (the IC plus seeded noise, with
    the Dirichlet values) and block planes, and a generator."""
    make, sizes, rule, split = CONFIGS[name]
    pb = make(nx=sizes[0], ny=sizes[0])
    F = pb.n_fields
    grids = [dataclasses.replace(pb.grid, nx=n, ny=n, rule_name=rule)
             for n in sizes]
    groups = pb.field_groups if split else None
    terms = pb.terms_precond if split else pb.terms
    rng = np.random.default_rng(seed)
    jvs, masks, ws, pinvs = [], [], [], []
    for g in grids:
        bcs = pb.dirichlet_for(g)
        jvs.append(pb.kernel_jvp(g, "cpu", bcs, split=split) if split
                   else pb.kernel_jvp(g, "cpu", bcs))
        m = bc_mask(g, bcs, F)
        masks.append(None if m is None else torch.as_tensor(m))
        v, c = g.interpolate(pb.ic_fns)
        w = _t(tuple((a + 0.02 * rng.standard_normal(a.shape)).astype(
            np.float32) for a in (v, c)))
        for bc in bcs:
            w = (bc.apply_value(w[0]).contiguous(), w[1])
        ws.append(w)
        pinvs.append(make_block_jacobi(g, terms, F, device="cpu",
                                       dirichlet=bcs)(w, w, DT).pinv_planes)
    return pb, grids, jvs, masks, groups, ws, pinvs, rng


def _pair(g, F, rng):
    return tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=torch.float32)
                 for s in (g.vshape, g.mshape))


def _groups(starts):
    return None if starts is None else tuple(
        tuple(range(a, b)) for a, b in zip(starts[:-1], starts[1:]))


# ---------------------------------------------------------------------------
# the table is what the launches take
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records each launcher's name and
    arguments, with the parameter block of a J.v or L launch copied out."""

    def __init__(self, param_floats):
        self.calls = []
        self.param_floats = param_floats
        self.lib = self

    def pfh_jvp_param_floats(self):
        return self.param_floats

    def call(self, name, *args):
        block = np.ctypeslib.as_array((ctypes.c_float * self.param_floats)
                                      .from_address(args[0])).copy()
        self.calls.append((name, block, args[1:]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_is_what_the_launches_take(name, monkeypatch):
    pb, grids, jvs, masks, groups, ws, pinvs, rng = _setup(name)
    F, K = pb.n_fields, len(grids) - 1
    descend = make_descend_chain(grids, jvs, masks=masks, field_groups=groups,
                                 **NU)
    ascend = make_ascend_chain(grids, jvs, masks=masks, field_groups=groups,
                               **NU)
    assert descend.one_launch and ascend.one_launch
    rec = _Recorder(jvs[0].launch.head.size + 1)
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_handle", lambda: 0)
    for chain, up in ((descend, False), (ascend, True)):
        plan = chain.plan
        assert (plan.K, plan.ascend, plan.kernel_name) == (
            K, up, "vcycle_ascend_chain" if up else "vcycle_descend_chain")
        assert plan.symbol == "pfh_vcycle_chain_" + jvs[0].launch.kind
        for l, lv in enumerate(plan.levels):
            g, gc = grids[l], grids[l + 1]
            assert (lv.fine, lv.coarse, lv.jv) == (g, gc, jvs[l])
            n = NU["nu_fine"] if l == 0 else NU["nu"]
            assert lv.n_sweeps == n
            # kernel L's launch of this level's sweeps, and the J.v's
            rec.calls.clear()
            x, r = _pair(g, F, rng), _pair(g, F, rng)
            lmr.lmr_sweep_kernel(jvs[l].launch, n, x, r, ws[l], DT, pinvs[l],
                                 groups)
            jvs[l].kernel(ws[l], ws[l], DT, x, b=r)
            (l_name, l_block, l_args), (j_name, j_block, j_args) = rec.calls
            assert l_name == "pfh_lmr_loop_" + plan.kind
            assert j_name == "pfh_" + plan.kind + "_jvp"
            np.testing.assert_array_equal(lv.params(DT), l_block)
            np.testing.assert_array_equal(lv.params(DT), j_block)
            n_var = len(plan.variant)
            assert l_args[:1 + n_var] == (plan.nq, *plan.variant)
            mask_ptr = l_args[1 + n_var + 12]
            assert mask_ptr == (None if lv.sweep_mask is None
                                else lv.sweep_mask.data_ptr())
            assert lv.sweep_mask is jvs[l].launch.mask
            nb, n_groups, starts, n_sweeps = l_args[1 + n_var + 14:
                                                    1 + n_var + 18]
            assert (lv.nb, n_sweeps) == (nb, n)
            assert lv.starts == (None if starts is None else tuple(starts))
            assert plan.n_groups == max(n_groups, 1)
            # the pair's transfer, as the level step's plan takes it
            tp = kt.TransferPlan(gc, g, F, "prolong" if up else "restrict",
                                 masks[l] if up else masks[l + 1])
            assert lv.R == tp.R and lv.transfer_mask is tp.mask
            if tp.R == 2:
                assert lv.weights is None
            else:
                np.testing.assert_array_equal(lv.weights,
                                              kt._general_params(tp.R))
        assert plan.need >= max(-(-F * (g.n_vertices_y * g.n_vertices_x
                                         + g.ny * g.nx) // 256)
                                for g in grids[:K])
    assert {lv.R for lv in ascend.plan.levels} == (
        {2, 5} if name == "mixed" else {2})


# ---------------------------------------------------------------------------
# the table, walked by the plain versions, gives the plain chains' bits
# ---------------------------------------------------------------------------

def _restrict(lv, r):
    f = kt.restrict_plain if lv.R == 2 else kt.restrict_general_plain
    return f(r, lv.coarse, lv.fine, lv.transfer_mask)


def _prolong_add(lv, xc, x):
    f = (kt.prolong_accumulate_plain if lv.R == 2
         else kt.prolong_general_accumulate_plain)
    return f(xc, lv.coarse, lv.fine, x, lv.transfer_mask)


def _sweeps(lv, x, r, w, pinv):
    lmr.make_lmr_sweep_loop(lv.jv, lv.n_sweeps, _groups(lv.starts)).plain(
        x, r, w, w, DT, *pinv)


def interpret_descend(plan, b, ws, pinvs):
    """vcycle_chain.cuh's descent, level by level from the table: x = 0,
    r = b; the sweeps; the restriction."""
    xs, bs = [], []
    for l, lv in enumerate(plan.levels):
        x = tuple(torch.zeros_like(t) for t in b)
        r = tuple(t.clone() for t in b)
        _sweeps(lv, x, r, ws[l], pinvs[l])
        xs.append(x)
        b = _restrict(lv, r)
        bs.append(b)
    return xs, bs[:-1], bs[-1]


def interpret_ascend(plan, bs, xs, xc, ws, pinvs):
    """vcycle_chain.cuh's ascent: x = x_l + P xc; r = b - J x; the sweeps."""
    for l in range(plan.K - 1, -1, -1):
        lv = plan.levels[l]
        x = _prolong_add(lv, xc, tuple(t.clone() for t in xs[l]))
        r = lv.jv.plain(ws[l], ws[l], DT, x, b=bs[l])
        _sweeps(lv, x, r, ws[l], pinvs[l])
        xc = x
    return xc


def _equal(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_interpreter_gives_the_plain_chains(name):
    pb, grids, jvs, masks, groups, ws, pinvs, rng = _setup(name)
    F, K = pb.n_fields, len(grids) - 1
    descend = make_descend_chain(grids, jvs, masks=masks, field_groups=groups,
                                 **NU)
    ascend = make_ascend_chain(grids, jvs, masks=masks, field_groups=groups,
                               **NU)
    b0 = _pair(grids[0], F, rng)
    _lib.reset_launches()
    xs, bs, bc = descend(b0, ws[:K], ws[:K], DT, pinvs[:K])
    xs_i, bs_i, bc_i = interpret_descend(descend.plan, b0, ws, pinvs)
    assert len(xs) == K and len(bs) == K - 1
    for got, ref in zip(xs + bs + [bc], xs_i + bs_i + [bc_i]):
        _equal(got, ref)
    xc = _pair(grids[-1], F, rng)
    z = ascend([b0] + bs, xs, xc, ws[:K], ws[:K], DT, pinvs[:K])
    _equal(z, interpret_ascend(ascend.plan, [b0] + bs, xs, xc, ws, pinvs))
    # a level step is a chain of one level: its table walks alike
    d = make_descend_level(grids[-2], grids[-1], jvs[-2], nu=3,
                           mask_coarse=masks[-1], field_groups=groups)
    a = make_ascend_level(grids[-2], grids[-1], jvs[-2], nu=3,
                          mask_fine=masks[-2], field_groups=groups)
    assert d.plan.K == a.plan.K == 1 and d.plan.levels[0].n_sweeps == 3
    b = _pair(grids[-2], F, rng)
    x, bc = d(b, ws[-2], ws[-2], DT, pinvs[-2])
    (x_i,), _, bc_i = interpret_descend(d.plan, b, ws[-2:], pinvs[-2:])
    _equal(x + bc, x_i + bc_i)
    _equal(a(b, x, xc, ws[-2], ws[-2], DT, pinvs[-2]),
           interpret_ascend(a.plan, [b], [x], xc, ws[-2:], pinvs[-2:]))
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())


# ---------------------------------------------------------------------------
# the mixed-ratio chains against the TPU chains in interpret mode
# ---------------------------------------------------------------------------

def test_mixed_ratio_chains_match_pallas_chains():
    pb, grids, jvs, masks, groups, ws, pinvs, rng = _setup("mixed")
    F, K = pb.n_fields, len(grids) - 1
    pj = make_jax3(nx=grids[0].nx, ny=grids[0].ny)
    jgrids = [dataclasses.replace(pj.grid, nx=g.nx, ny=g.ny,
                                  rule_name=g.rule_name) for g in grids]
    np_ws = [tuple(t.numpy() for t in w) for w in ws[:K]]
    jw = [tuple(jnp.asarray(a) for a in w) for w in np_ws]
    jp = [tuple(jnp.asarray(np.asarray(a)) for a in jax_bj(
        g, pj.terms, F, dtype=jnp.float32)(w, w, DT).pinv_planes)
        for g, w in zip(jgrids[:K], jw)]
    tp = [_t(tuple(np.asarray(a) for a in p)) for p in jp]
    b = _pair(grids[0], F, rng)
    xc = _pair(grids[-1], F, rng)
    jb, jxc = (tuple(jnp.asarray(t.numpy()) for t in p) for p in (b, xc))

    # one sweep a level: interpret mode's compile grows with the sweeps
    nu = dict(nu=1)
    jd = make_fused_descend_chain(jgrids, pj.terms, F, interpret=True, **nu)
    ja = make_fused_ascend_chain(jgrids, pj.terms, F, interpret=True, **nu)
    xs_j, bs_j, bc_j = jd(jb, jw, jw, DT, jp)
    z_j = ja([jb] + list(bs_j), xs_j, jxc, jw, jw, DT, jp)

    descend = make_descend_chain(grids, jvs, masks=masks, **nu)
    ascend = make_ascend_chain(grids, jvs, masks=masks, **nu)
    assert [lv.R for lv in descend.plan.levels] == [2, 5]
    xs_t, bs_t, bc_t = descend(b, ws[:K], ws[:K], DT, tp)
    # the ascent starts from the JAX descent's outputs, so each chain is
    # compared on its own
    z_t = ascend([b] + [_t(tuple(np.asarray(a) for a in p)) for p in bs_j],
                 [_t(tuple(np.asarray(a) for a in p)) for p in xs_j], xc,
                 ws[:K], ws[:K], DT, tp)
    for got, ref in zip(list(xs_t) + list(bs_t) + [bc_t, z_t],
                        list(xs_j) + list(bs_j) + [bc_j, z_j]):
        for a, r in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(r), **F32)


# ---------------------------------------------------------------------------
# what has no kernel, and the CPU route
# ---------------------------------------------------------------------------

def test_levels_of_other_point_counts_or_routes_have_no_kernel():
    pb, grids, jvs, masks, groups, ws, pinvs, rng = _setup("bench1")
    other = pb.kernel_jvp(dataclasses.replace(grids[1], rule_name="ffc3"),
                          "cpu")
    assert other.launch.nq != jvs[0].launch.nq
    with pytest.raises(ValueError, match="one point count"):
        ChainPlan(grids, [jvs[0], other, jvs[2]], [1, 2], masks, None,
                  ascend=False)
    with pytest.raises(ValueError, match="one point count"):
        make_ascend_chain(grids, [jvs[0], other, jvs[2]], masks=masks, **NU)
    # a level routed to the tile kernels: the chain runs its sequence
    tiled = pb.kernel_jvp(grids[0], "cpu", form="seam")
    assert getattr(tiled, "tile_sweep", None) is not None
    chain = make_descend_chain(grids, [tiled] + jvs[1:], masks=masks, **NU)
    assert not chain.one_launch and chain.plan is None
    with pytest.raises(NotImplementedError, match="sequence"):
        chain.kernel(_pair(grids[0], 2, rng), ws[:2], ws[:2], DT, pinvs[:2])
    with pytest.raises(ValueError, match="gather levels"):
        ChainPlan(grids, [tiled] + jvs[1:], [1, 2], masks, None, ascend=True)


def test_cpu_chains_take_the_plain_versions_and_the_kernels_raise():
    pb, grids, jvs, masks, groups, ws, pinvs, rng = _setup("bench6")
    F, K = pb.n_fields, len(grids) - 1
    descend = make_descend_chain(grids, jvs, masks=masks, **NU)
    b0 = _pair(grids[0], F, rng)
    _lib.reset_launches()
    got = descend(b0, ws[:K], ws[:K], DT, pinvs[:K])
    ref = descend.plain(b0, ws[:K], ws[:K], DT, pinvs[:K])
    for g, r in zip(got[0] + got[1] + [got[2]], ref[0] + ref[1] + [ref[2]]):
        _equal(g, r)
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())
    with pytest.raises(ValueError, match="CUDA"):
        descend.kernel(b0, ws[:K], ws[:K], DT, pinvs[:K])
