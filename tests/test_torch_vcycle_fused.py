"""Kernel V's CPU side (ops/vcycle_fused.py ``VcyclePlan``: TPU row 5, a
V-cycle apply and its exported A z in one launch on the card), with the
split apply and the JAX package as the oracles:

- the plan's table is what the split apply's launches take today: the
  descend and ascend chains' records (``ChainPlan``), kernel L's launch of
  the coarsest sweeps and the exported J.v's parameter block (kernel W's
  plan), each read from the calls of a recording stand-in for the library;
  and the records share their planes as the kernel reads them;
- a plain interpreter that walks the table's records in the kernel's
  order, each node loop and dot-slot loop split over the CTAs of a scope
  (the grid, and cluster 0), gives the bits of the plain split apply
  (``torch.equal``): a bench1-like 3-level dunavant2 hierarchy with the
  ffc3 matvec, bench2 split at NE 4 and NE 1 with the coupled matvec, and a
  mixed-ratio hierarchy (ratios 2 and 5, so H's bodies run);
- V's plain version against ``make_fused_vcycle(..., with_matvec=True,
  interpret=True)`` of the JAX package at 16^2 in bench2's form (split
  dunavant1 levels, the coupled ffc3 matvec) with one order parameter (four
  would take minutes of interpret-mode tracing), at the f32 tolerances of
  tests/test_pallas_vcycle.py (rtol 2e-4, atol 2e-5);
- routing: ``fuse_vcycle`` "auto" takes V only where the JAX package's gate
  holds; ``split_chain``, ``split_levels``, Dirichlet rows on the fine
  level and CPU tensors keep the split apply; on the CPU V launches nothing.
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu.ops.pallas_vcycle import (
    make_fused_vcycle as jax_fused_vcycle)
from pfhubbenchmarks_tpu.solve.precond import make_block_jacobi as jax_bj
from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench6
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt
from pfhubbenchmarks_tpu_torch.ops import vcycle_fused as vf
from pfhubbenchmarks_tpu_torch.solve.gmg import fused_gate, make_gmg
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
DT = 0.04
NU = dict(nu_pre=2, nu_post=3, nu_fine_pre=1, nu_fine_post=2, coarse_sweeps=4)

# name: (make, its kwargs, level sizes, level rule, field split)
CONFIGS = {
    "bench1": (bench1.make, {}, (16, 8, 4), "dunavant2", False),
    "bench2_ne4": (bench2.make, {}, (8, 4, 2), "dunavant1", True),
    "bench2_ne1": (bench2.make, dict(num_eta=1), (8, 4, 2), "dunavant1",
                   True),
    "mixed": (bench1.make, {}, (10, 5, 1), "dunavant2", False),
}


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _setup(name, seed=7):
    """The problem, its levels at the level rule and their J.v, the
    exported J.v (the box form at the true rule), the field groups, the
    per-level states (the IC plus seeded noise) and block planes, and a
    generator."""
    make, kw, sizes, rule, split = CONFIGS[name]
    pb = make(nx=sizes[0], ny=sizes[0], **kw)
    F = pb.n_fields
    grids = [dataclasses.replace(pb.grid, nx=n, ny=n, rule_name=rule)
             for n in sizes]
    groups = pb.field_groups if split else None
    terms = pb.terms_precond if split else pb.terms
    rng = np.random.default_rng(seed)
    jvs, ws, pinvs = [], [], []
    for g in grids:
        jvs.append(pb.kernel_jvp(g, "cpu", split=split) if split
                   else pb.kernel_jvp(g, "cpu"))
        v, c = g.interpolate(pb.ic_fns)
        ws.append(_t(tuple((a + 0.02 * rng.standard_normal(a.shape)).astype(
            np.float32) for a in (v, c))))
        pinvs.append(make_block_jacobi(g, terms, F, device="cpu")(
            ws[-1], ws[-1], DT).pinv_planes)
    mv = pb.kernel_jvp(pb.grid, "cpu", form="box")
    return pb, grids, jvs, mv, groups, ws, pinvs, rng


def _pair(g, F, rng):
    return tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=torch.float32)
                 for s in (g.vshape, g.mshape))


def _equal(got, ref):
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the table is what the split apply's launches take
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records every record the plans
    pack and every launch, with the parameter blocks copied out."""

    LEVEL_BYTES = 16

    def __init__(self, param_floats):
        self.param_floats = param_floats
        self.lib = self
        self.packs, self.calls, self.launches = [], [], []

    def _block(self, addr):
        return np.ctypeslib.as_array((ctypes.c_float * self.param_floats)
                                     .from_address(addr)).copy()

    def pfh_jvp_param_floats(self):
        return self.param_floats

    def pfh_vcycle_chain_level_bytes(self):
        return self.LEVEL_BYTES

    def call(self, name, *args):
        if name == "pfh_vcycle_chain_pack":
            _, params, weights, ptrs, ints, starts = args
            self.packs.append(dict(
                params=self._block(params),
                weights=None if weights is None else np.ctypeslib.as_array(
                    (ctypes.c_float * kt._general_params(7).size)
                    .from_address(weights)).copy(),
                ptrs=list(ptrs), ints=list(ints),
                starts=None if starts is None else tuple(starts)))
        else:
            self.calls.append((name, self._block(args[0]), args[1:]))

    def __getattr__(self, name):
        if not name.startswith("pfh_"):
            raise AttributeError(name)

        def launcher(*args):
            self.launches.append((name, args))
            return 0

        return launcher


def _bind(monkeypatch, rec):
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_handle", lambda: 0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_table_is_what_the_split_launches_take(name, monkeypatch):
    pb, grids, jvs, mv, groups, ws, pinvs, rng = _setup(name)
    F, K = pb.n_fields, len(grids) - 1
    vc = vf.make_fused_vcycle(grids, jvs, mv, field_groups=groups, **NU)
    plan = vc.plan
    rec = _Recorder(jvs[0].launch.head.size + 1)
    _bind(monkeypatch, rec)
    b = _pair(grids[0], F, rng)
    vc.kernel(b, ws, ws, DT, pinvs)
    v_packs = rec.packs
    assert len(v_packs) == 2 * K + 1
    (sym, args), = rec.launches
    assert sym == "pfh_vcycle_fused_" + jvs[0].launch.kind
    n_var = len(plan.variant)
    assert args[:2 + n_var] == (vf.LEVEL_NQ[plan.kind], vf.MV_NQ,
                                *plan.variant)
    K_, need, cluster, cluster_from, phases = args[3 + n_var: 8 + n_var]
    on_cluster = vf.coarse_on_cluster(plan.coarse_ctas)
    assert (K_, phases) == (K, vf.ALL_PHASES)
    assert (cluster_from, cluster) == ((K, vf.CLUSTER) if on_cluster
                                       else (K + 1, 1))
    assert need == plan.need >= max(
        -(-F * (g.n_vertices_y * g.n_vertices_x + g.ny * g.nx) // 256)
        for g in grids)
    assert args[8 + n_var: 14 + n_var] == tuple(
        t.data_ptr() for t in b) + args[10 + n_var: 14 + n_var]

    # the chains' records, as ChainPlan packs them for the split apply
    rec.packs = []
    xs, bs, bc = vc.descend.kernel(b, ws[:K], ws[:K], DT, pinvs[:K])
    vc.ascend.kernel([b] + bs, xs, _pair(grids[-1], F, rng), ws[:K], ws[:K],
                     DT, pinvs[:K])
    c_packs = rec.packs
    assert len(c_packs) == 2 * K
    for i, (vp, cp) in enumerate(zip(v_packs[:K] + v_packs[K + 1:],
                                     c_packs)):
        np.testing.assert_array_equal(vp["params"], cp["params"])
        assert vp["ints"] == cp["ints"] and vp["starts"] == cp["starts"]
        assert (vp["weights"] is None) == (cp["weights"] is None)
        if vp["weights"] is not None:
            np.testing.assert_array_equal(vp["weights"], cp["weights"])
        # the states, block planes and masks: the same operands
        assert vp["ptrs"][8:13] == cp["ptrs"][8:13]

    # the coarsest record: kernel L's launch of the coarse sweeps
    rec.calls = []
    x, r = _pair(grids[-1], F, rng), _pair(grids[-1], F, rng)
    lmr.lmr_sweep_kernel(jvs[K].launch, NU["coarse_sweeps"], x, r, ws[K], DT,
                         pinvs[K], groups)
    (l_name, l_block, l_args), = rec.calls
    cr = v_packs[K]
    np.testing.assert_array_equal(cr["params"], l_block)
    n_lvar = len(jvs[K].launch.variant)
    nb, n_groups, starts, n_sweeps = l_args[1 + n_lvar + 14:
                                            1 + n_lvar + 18]
    assert cr["ints"] == [F, grids[-1].ny, grids[-1].nx, n_sweeps, nb,
                          n_groups, 0, 0, 0]
    assert cr["starts"] == (None if starts is None else tuple(starts))
    assert cr["ptrs"][8:13] == [*(t.data_ptr() for t in pinvs[K]),
                                *(t.data_ptr() for t in ws[K]), None]

    # the matvec's block: the exported J.v's (W's plan) with dt
    rec.launches = []
    mv.kernel(ws[0], ws[0], DT, b)
    (w_sym, w_args), = rec.launches
    assert w_sym == mv.plan.symbol
    off = (2 * K + 1) * rec.LEVEL_BYTES
    np.testing.assert_array_equal(plan._host[off:].view(np.float32),
                                  rec._block(w_args[0]))

    # the planes the records share, as the kernel reads them
    def at(i, k):
        return v_packs[i]["ptrs"][k]

    X, R_, Z, AZ, PART, B, XIN, T = 0, 2, 4, 6, 13, 14, 16, 18
    for l in range(K):
        d, a = l, K + 1 + l
        for k in (R_, R_ + 1, Z, Z + 1, AZ, AZ + 1, PART):
            assert at(d, k) == at(a, k)
        assert at(a, XIN) == at(d, X) and at(a, XIN + 1) == at(d, X + 1)
        nxt = K if l + 1 == K else l + 1
        assert at(nxt, B) == at(d, T) and at(nxt, B + 1) == at(d, T + 1)
        if l > 0:
            assert at(a, X) == at(d, X) and at(a, B) == at(d, B)
        else:
            assert at(a, X) is None and at(a, B) is None and at(d, B) is None
    assert len({at(i, PART) for i in range(K + 1)}) == K + 1


@pytest.mark.parametrize("name,ne,ctas,on_cluster", [
    ("bench1", None, 11, True), ("bench2", 4, 155, False),
    ("bench2", 2, 63, False), ("bench2", 1, 32, True)])
def test_the_plans_scope_rule_at_the_main_hierarchies(name, ne, ctas,
                                                      on_cluster):
    """The coarsest level's CTAs of work (its nodes over 256 threads, its dot
    slots) at the main paths' 100/50/25, and the scope the plan gives it."""
    pb = bench1.make() if ne is None else bench2.make(num_eta=ne)
    s, split = pb.solver, ne is not None
    grids = [dataclasses.replace(g, rule_name=s.precond_rule) for g in
             pb.precond_builder("cpu").grids]
    assert [g.nx for g in grids] == [100, 50, 25]
    jvs = [pb.kernel_jvp(g, "cpu", split=split) if split
           else pb.kernel_jvp(g, "cpu") for g in grids]
    plan = vf.VcyclePlan(grids, jvs, pb.kernel_jvp(pb.grid, "cpu").launch,
                         pre=[1, 3], post=[3, 3], coarse_sweeps=8,
                         field_groups=pb.field_groups if split else None)
    assert plan.coarse_ctas == ctas
    assert vf.coarse_on_cluster(ctas) == on_cluster
    assert (plan.cluster_from, plan.cluster) == (
        (2, vf.CLUSTER) if on_cluster else (3, 1))


# ---------------------------------------------------------------------------
# the table, walked by the plain versions, gives the plain split apply
# ---------------------------------------------------------------------------

THREADS = 256


def _owners(n, size):
    """The thread-stride ownership of n items over a scope of ``size`` CTAs:
    per CTA the items its loop writes (idx = rank * 256 + t, stepping by
    size * 256)."""
    own = [(np.arange(rank * THREADS, n, size * THREADS)[:, None]
            + np.arange(THREADS)[None, :]).ravel() for rank in range(size)]
    return [o[o < n] for o in own]


def _walk(n, size):
    """Every item written once over the scope's CTAs; returns the order."""
    idx = np.concatenate(_owners(n, size))
    assert np.array_equal(np.sort(idx), np.arange(n))
    return idx


def _scoped(pair, size):
    """A copy of ``pair`` written node by node in the scope's order (the
    node loops own a node's every field)."""
    out = tuple(torch.full_like(t, float("nan")) for t in pair)
    nv = pair[0][0].numel()
    flat = [t.reshape(t.shape[0], -1) for t in pair]
    for idx in _walk(nv + pair[1][0].numel(), size):
        if idx < nv:
            out[0].reshape(out[0].shape[0], -1)[:, idx] = flat[0][:, idx]
        else:
            out[1].reshape(out[1].shape[0], -1)[:, idx - nv] = \
                flat[1][:, idx - nv]
    return out


def interpret(plan, parts, b, ws, pinvs, scopes):
    """csrc/vcycle_fused.cuh's phases from the table's records, in the
    kernel's order: the descent's records, the coarsest's, the ascent's
    from level K-1 down; ``scopes[l]``, the CTAs level l's loops stride
    over. Returns (z, A z)."""
    K = plan.K
    recs = plan.records()
    groups = (None if plan.starts is None else tuple(
        tuple(range(a, c)) for a, c in zip(plan.starts[:-1],
                                           plan.starts[1:])))
    P = {}

    def sweeps(l, n, x, r):
        _walk(plan.n_groups * plan.nbs[l], scopes[l])  # the dot slots
        lmr.make_lmr_sweep_loop(plan.jvs[l], n, groups).plain(
            x, r, ws[l], ws[l], DT, *pinvs[l])

    def start(l, bb):
        x = _scoped(tuple(torch.zeros_like(t) for t in bb), scopes[l])
        return x, _scoped(bb, scopes[l])

    for l, n, R, x, bk, xin, t in recs[:K]:
        x, r = start(l, b if bk == 0 else P[bk])
        sweeps(l, n, x, r)
        P[(l, "x")] = x
        f = kt.restrict_plain if R == 2 else kt.restrict_general_plain
        P[(l, "t")] = f(r, plan.grids[l + 1], plan.grids[l], None)
    l, n, _, x, bk, _, _ = recs[K]
    x, r = start(l, P[bk])
    sweeps(l, n, x, r)
    P[(K, "x")] = x
    for l, n, R, x, bk, xin, t in reversed(recs[K + 1:]):
        f = (kt.prolong_accumulate_plain if R == 2
             else kt.prolong_general_accumulate_plain)
        xl = f(P[(l + 1, "x")], plan.grids[l + 1], plan.grids[l],
               tuple(u.clone() for u in P[xin]), None)
        bb = b if bk == 0 else P[bk]
        r = plan.jvs[l].plain(ws[l], ws[l], DT, xl, b=bb)
        sweeps(l, n, xl, r)
        P[(l, "x")] = xl
    z = P[(0, "x")]
    return z, parts.plain(ws[0], ws[0], DT, z)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_interpreter_gives_the_plain_split_apply(name):
    pb, grids, jvs, mv, groups, ws, pinvs, rng = _setup(name)
    F = pb.n_fields
    vc = vf.make_fused_vcycle(grids, jvs, mv, field_groups=groups, **NU)
    plan = vc.plan
    assert [R for _, _, R, *_ in plan.records()] == (
        plan.ratios + [0] + plan.ratios)
    assert plan.ratios == ([2, 5] if name == "mixed" else [2, 2])
    b = _pair(grids[0], F, rng)
    _lib.reset_launches()
    z, az = vc(b, ws, ws, DT, pinvs)
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())
    _equal(z + az, sum(vc.plain(b, ws, ws, DT, pinvs), ()))
    grid_ctas = min(plan.need, 112)
    K = plan.K
    for cluster_from in (K, K + 1):   # the coarsest on cluster 0, on the grid
        scopes = [vf.CLUSTER if l >= cluster_from else grid_ctas
                  for l in range(K + 1)]
        zi, azi = interpret(plan, mv, b, ws, pinvs, scopes)
        _equal(z + az, zi + azi)


# ---------------------------------------------------------------------------
# against the TPU kernel in interpret mode
# ---------------------------------------------------------------------------

def test_plain_v_matches_pallas_fused_vcycle_bench2_form():
    n, sweeps = 16, dict(nu_pre=1, nu_post=1, coarse_sweeps=2)
    pt = bench2.make(nx=n, ny=n, num_eta=1)
    pj = make_jax2(nx=n, ny=n, num_eta=1)
    F = pt.n_fields
    sizes = (16, 8)
    grids = [dataclasses.replace(pt.grid, nx=s, ny=s, rule_name="dunavant1")
             for s in sizes]
    jgrids = [dataclasses.replace(pj.grid, nx=s, ny=s, rule_name="dunavant1")
              for s in sizes]
    rng = np.random.default_rng(3)
    ws, jw = [], []
    for g in grids:
        v, c = g.interpolate(pt.ic_fns)
        w = tuple((a + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)
                  for a in (v, c))
        ws.append(_t(w))
        jw.append(tuple(jnp.asarray(a) for a in w))
    jp = [tuple(jnp.asarray(np.asarray(a)) for a in jax_bj(
        g, pj.terms_precond, F, dtype=jnp.float32)(w, w, DT).pinv_planes)
        for g, w in zip(jgrids, jw)]
    tp = [_t(tuple(np.asarray(a) for a in p)) for p in jp]
    b = _pair(grids[0], F, rng)
    jb = tuple(jnp.asarray(t.numpy()) for t in b)
    groups = pt.field_groups
    jf = jax_fused_vcycle(jgrids, pj.terms_precond, F, dtype=jnp.float32,
                          with_matvec=True, matvec_grid=pj.grid,
                          matvec_terms=pj.terms, field_groups=groups,
                          alpha_groups=groups, interpret=True, **sweeps)
    z_j, az_j = jf(jb, jw, jw, DT, jp)
    jvs = [pt.kernel_jvp(g, "cpu", split=True) for g in grids]
    vc = vf.make_fused_vcycle(grids, jvs, pt.kernel_jvp(pt.grid, "cpu",
                                                        form="box"),
                              field_groups=groups, **sweeps)
    z_t, az_t = vc(b, ws, ws, DT, tp)
    for got, ref in ((z_t, z_j), (az_t, az_j)):
        for a, r in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(r), **F32)


# ---------------------------------------------------------------------------
# routing, and the CPU route
# ---------------------------------------------------------------------------

def _gate_inputs(pb, sizes, split):
    grids = [dataclasses.replace(pb.grid, nx=s, ny=s) for s in sizes]
    jvs = [pb.kernel_jvp(g, "cpu", pb.dirichlet_for(g), split=split)
           if split else pb.kernel_jvp(g, "cpu", pb.dirichlet_for(g))
           for g in grids]
    return grids, jvs, [pb.dirichlet_for(g) for g in grids]


def test_auto_routes_to_v_only_where_the_jax_gate_holds():
    b1 = _gate_inputs(bench1.make(nx=16, ny=16), (16, 8), False)
    b2 = _gate_inputs(bench2.make(nx=8, ny=8), (8, 4), True)
    b6 = _gate_inputs(bench6.make(nx=16, ny=16), (16, 8), False)
    for grids, jvs, bcs in (b1, b2):
        assert fused_gate(grids, jvs, bcs, "auto", "cuda")
        assert fused_gate(grids, jvs, bcs, "auto", torch.device("cuda", 0))
        for off in ("off", "split_chain", "split_levels"):
            assert not fused_gate(grids, jvs, bcs, off, "cuda")
        assert not fused_gate(grids, jvs, bcs, "auto", "cpu")
        assert not fused_gate(grids[:1], jvs[:1], bcs[:1], "auto", "cuda")
    # Dirichlet rows on the fine level (bench6): the chains
    assert b6[2][0]
    assert not fused_gate(*b6, "auto", "cuda")
    # a tiled level, and a pair of unequal ratios: no V
    grids, jvs, bcs = b1
    tiled = bench1.make(nx=16, ny=16).kernel_jvp(grids[0], "cpu", form="seam")
    assert not fused_gate(grids, [tiled] + jvs[1:], bcs, "auto", "cuda")
    odd = [grids[0], dataclasses.replace(grids[0], nx=8, ny=4)]
    assert not fused_gate(odd, jvs, bcs, "auto", "cuda")
    # V's instantiations only: another level rule is refused at build
    with pytest.raises(NotImplementedError, match="points"):
        vf.VcyclePlan(grids, jvs, jvs[0].launch, pre=[1], post=[1],
                      coarse_sweeps=2)


def test_cpu_builds_keep_the_split_apply_and_launch_nothing():
    pb = bench1.make(nx=16, ny=16)
    s = pb.solver
    build = make_gmg(pb.grid, pb.terms, 2, device="cpu",
                     jvp_for=lambda g, split, form="gather": pb.kernel_jvp(
                         g, "cpu", (), form=form),
                     mv_form="box", min_cells=4, nu_pre=s.gmg_nu_pre,
                     coarse_sweeps=s.gmg_coarse_sweeps)
    assert build.vcycle is None
    pb, grids, jvs, mv, groups, ws, pinvs, rng = _setup("bench1")
    vc = vf.make_fused_vcycle(grids, jvs, mv, **NU)
    b = _pair(grids[0], 2, rng)
    _lib.reset_launches()
    _equal(sum(vc(b, ws, ws, DT, pinvs), ()),
           sum(vc.plain(b, ws, ws, DT, pinvs), ()))
    assert all(n == 0 for n in {**_lib.LAUNCHES, **_lib.CALLS}.values())
    with pytest.raises(ValueError, match="CUDA"):
        vc.kernel(b, ws, ws, DT, pinvs)
