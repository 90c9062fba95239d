"""N's one-launch build (ops/node_blocks.NodeBuildPlan, the
``node_build_kernel`` of csrc/node_blocks.cuh) on the CPU, where it cannot
run:

- the levels' records cover every node of every level exactly once, in
  the launch's node order, and the kernel's addressing through them
  (transliterated) writes every element of the planes and of the coarse
  levels' injected states exactly once: bench1 100/50/25, bench6 (its
  Dirichlet masks), bench2 (six fields) and bench3 350/175/35/7 (ratios 2,
  5, 5);
- the composed injection index is the chained state injections
  (ops/transfer.TransferPlan "inject": kernel D's plain version at a dyadic
  pair, strided slicing at an odd ratio), to the bit, at the same
  hierarchies;
- a plain interpreter of the table (each level's state read through the
  composed index, its plain planes, both stored at the records' offsets and
  read back through ``NodeBuildPlan.views``) gives, with ``torch.equal``,
  what the plan gives on CPU tensors, which is today's build: each level's
  plain planes and the chained injections;
- a numpy transliteration of the lane split (lane j owns column j of
  [P | I]; per pivot the pivot column by shuffles, then each lane's row
  operations) gives the one-thread Gauss-Jordan of ``node_blocks_kernel``
  bit for bit: F = 2 in the exact form (every product and difference
  rounded apart), F = 3 with a Dirichlet mask and F = 6 field-split in the
  contracted form (each ``a - f x`` rounded once), and it is the inverse;
- the multigrid build (solve/gmg.py) goes through the plan; what the
  launcher receives (a recording stand-in for the library); the refusals.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu_torch.benchmarks import bench1, bench2, bench3, bench6
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.node_blocks import (RECORD, NodeBlockPlan,
                                                       NodeBuildPlan,
                                                       composed_index)
from pfhubbenchmarks_tpu_torch.ops.transfer import inject_general, inject_plain
from pfhubbenchmarks_tpu_torch.solve.gmg import build_hierarchy

DT = 0.25
# name: (make, cells, kwargs); the benchmarks' own min_cells
CASES = {"bench1": (bench1.make, 100, {}), "bench6": (bench6.make, 100, {}),
         "bench2": (bench2.make, 100, {}), "bench3": (bench3.make, 350, {})}
# the smaller hierarchies the planes are built on (bench3 70/35/7: 2, 5)
SMALL = {"bench1": 16, "bench6": 16, "bench2": 8, "bench3": 70}
MIN_CELLS = {"bench1": 4, "bench6": 4, "bench2": 4, "bench3": 7}


def _plans(pb, grids):
    s = pb.solver
    split = s.field_split and pb.terms_precond is not None
    levels = []
    for g in grids:
        bcs = pb.dirichlet_for(g)
        levels.append(NodeBlockPlan(
            g, pb.kernel_jvp(g, "cpu", bcs, split=split),
            pb.terms_precond if split else pb.terms, device="cpu",
            dirichlet=bcs))
    return NodeBuildPlan(grids, levels, device="cpu")


@functools.cache
def _full(name):
    """The plan at the benchmark's full hierarchy (no planes are built)."""
    make, n, kw = CASES[name]
    pb = make(nx=n, ny=n, **kw)
    s = pb.solver
    grids = [dataclasses.replace(g, rule_name=s.precond_rule)
             for g in build_hierarchy(pb.grid, min_cells=s.gmg_min_cells)]
    return pb, _plans(pb, grids)


@functools.cache
def _small(name):
    make, _, kw = CASES[name]
    n = SMALL[name]
    pb = make(nx=n, ny=n, **kw)
    grids = [dataclasses.replace(g, rule_name=pb.solver.precond_rule)
             for g in build_hierarchy(pb.grid, min_cells=MIN_CELLS[name])]
    assert len(grids) >= 2
    return pb, _plans(pb, grids)


def _state(pb, g, seed):
    """The IC on ``g`` plus seeded noise, with its Dirichlet values."""
    rng = np.random.default_rng(seed)
    v, m = g.interpolate(pb.ic_fns)
    v, m = (torch.tensor(a + 0.01 * rng.standard_normal(a.shape),
                         dtype=torch.float32) for a in (v, m))
    for bc in pb.dirichlet_for(g):
        v = bc.apply_value(v)
    return v.contiguous(), m


def test_hierarchies_are_the_main_paths():
    assert [g.nx for g in _full("bench1")[1].grids] == [100, 50, 25]
    assert [g.nx for g in _full("bench6")[1].grids] == [100, 50, 25]
    assert [g.nx for g in _full("bench2")[1].grids] == [100, 50, 25]
    assert [g.nx for g in _full("bench3")[1].grids] == [350, 175, 35, 7]
    assert [inj.R for inj in _full("bench3")[1].injs] == [2, 5, 5]


@pytest.mark.parametrize("name", sorted(CASES))
def test_records_cover_every_node_and_output_once(name):
    _, nb = _full(name)
    F, rec = nb.F, nb.records
    col = {k: RECORD.index(k) for k in RECORD}
    first = 0
    planes = np.zeros(nb._sizes[0], np.int32)
    states = np.zeros(max(nb._sizes[1], 1), np.int32)
    for l, (g, p) in enumerate(zip(nb.grids, nb.levels)):
        nv, nc = int(rec[l, col["nvert"]]), int(rec[l, col["ncell"]])
        assert (nv, nc) == ((g.ny + 1) * (g.nx + 1), g.ny * g.nx)
        assert rec[l, col["first"]] == first
        first += nv + nc
        assert (rec[l, col["mask"]] >= 0) == (p.mask is not None)
        assert (rec[l, col["src"]] < 0) == (rec[l, col["states"]] < 0) == (l == 0)
        # the kernel's stores, node by node: out[(i F + j) n + node] after
        # the vertex block, st[j n + node] and st[F (nv + nc) + j n + node]
        for on_v, n in ((True, nv), (False, nc)):
            node = np.arange(n)
            base = rec[l, col["planes"]] + (0 if on_v else F * F * nv)
            for i in range(F):
                for j in range(F):
                    np.add.at(planes, base + (i * F + j) * n + node, 1)
            if l:
                st = rec[l, col["states"]] + (0 if on_v else F * nv)
                for j in range(F):
                    np.add.at(states, st + j * n + node, 1)
                    np.add.at(states, st + F * (nv + nc) + j * n + node, 1)
        # the composed index and the diagonals of the level
        if l:
            o = int(rec[l, col["src"]])
            assert nb.src[o:o + nv + nc].numel() == nv + nc
        o = int(rec[l, col["diag"]])
        assert torch.equal(nb.diag[o:o + 3 * (nv + nc)], p.diag.reshape(-1))
        if p.mask is not None:
            o = int(rec[l, col["mask"]])
            assert torch.equal(nb.mask[o:o + F * nv], p.mask.reshape(-1))
    assert first == nb.total
    assert (planes == 1).all()
    assert (states == 1).all()
    assert nb.src.numel() == nb.total - (rec[0, 0] + rec[0, 1])
    assert nb.table.dtype == torch.int64 and nb.table.shape == (
        len(nb.grids), len(RECORD))


def _gather(w, idx):
    """The finest state pair ``w`` read at the composed index: the level's
    (v, m) as flat per-field rows."""
    flat = torch.cat([w[0].reshape(w[0].shape[0], -1),
                      w[1].reshape(w[1].shape[0], -1)], dim=1)
    return flat[:, torch.as_tensor(idx, dtype=torch.long)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_composed_index_is_the_chained_injections(name):
    pb, nb = _full(name)
    grids, F = nb.grids, nb.F
    rng = np.random.default_rng(sorted(CASES).index(name))
    w = tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=torch.float32)
              for s in (grids[0].vshape, grids[0].mshape))
    idx = composed_index(grids)
    assert idx[0] is None
    wl = w
    for l in range(1, len(grids)):
        c, f = grids[l], grids[l - 1]
        wl = (inject_plain if nb.injs[l - 1].R == 2 else inject_general)(wl, c, f)
        got = _gather(w, idx[l])
        ref = torch.cat([wl[0].reshape(F, -1), wl[1].reshape(F, -1)], dim=1)
        assert torch.equal(got, ref)
        assert torch.equal(nb.src[nb.records[l, RECORD.index("src")]:][
            :got.shape[1]].long(), torch.as_tensor(idx[l]))


def _interpret(nb, w, w0, dt):
    """The kernel's table on the CPU: each level's state read through the
    composed index into its records' states offsets, its plain planes at its
    planes offset, read back through the plan's views."""
    F, rec, col = nb.F, nb.records, RECORD.index
    planes = torch.full((nb._sizes[0],), float("nan"))
    states = torch.full((max(nb._sizes[1], 1),), float("nan"))
    idx = composed_index(nb.grids)
    for l, (g, p) in enumerate(zip(nb.grids, nb.levels)):
        nv, nc = p.nvert, p.ncell
        if l == 0:
            wl, w0l = w, w0
        else:
            o = int(rec[l, col("states")])
            for src in (w, w0):
                flat = _gather(src, idx[l])
                states[o:o + F * nv] = flat[:, :nv].reshape(-1)
                states[o + F * nv:o + F * (nv + nc)] = flat[:, nv:].reshape(-1)
                o += F * (nv + nc)
            o = int(rec[l, col("states")])
            wl = (states[o:o + F * nv].view(F, *g.vshape),
                  states[o + F * nv:o + F * (nv + nc)].view(F, *g.mshape))
            o += F * (nv + nc)
            w0l = (states[o:o + F * nv].view(F, *g.vshape),
                   states[o + F * nv:o + F * (nv + nc)].view(F, *g.mshape))
        pv, pm = p.plain(wl, w0l, dt)
        o = int(rec[l, col("planes")])
        planes[o:o + F * F * nv] = pv.reshape(-1)
        planes[o + F * F * nv:o + F * F * (nv + nc)] = pm.reshape(-1)
    return nb.views(w, w0, planes, states)


def _flat(out):
    states, planes = out
    return ([t for pair in states for half in pair for t in half]
            + [t for p in planes for t in p])


@pytest.mark.parametrize("name", sorted(CASES))
def test_table_interpreter_and_cpu_build_are_todays_build(name):
    pb, nb = _small(name)
    g0 = nb.grids[0]
    w, w0 = _state(pb, g0, 1), _state(pb, g0, 2)
    got = nb(w, w0, DT)
    # today's build: per level the plain planes, then the chained injections
    states, planes = [], []
    wl, w0l = w, w0
    for l, p in enumerate(nb.levels):
        states.append((wl, w0l))
        planes.append(p.plain(wl, w0l, DT))
        if l + 1 < len(nb.levels):
            wl, w0l = nb.injs[l].plain(wl), nb.injs[l].plain(w0l)
    for a, b in zip(_flat(got), _flat((states, planes))):
        assert torch.equal(a, b)
    interp = _interpret(nb, w, w0, DT)
    for a, b in zip(_flat(interp), _flat(got)):
        assert a.shape == b.shape and a.is_contiguous()
        assert torch.equal(a, b)


# ---- the lane split, transliterated ----------------------------------------

def _exact(a, f, x):
    """__fsub_rn(a, __fmul_rn(f, x))."""
    return np.float32(a - np.float32(f * x))


def _contracted(a, f, x):
    """a - f * x contracted to one FMA: the f64 product of two f32 is exact,
    so one rounding of the f64 difference to f32 (the rare double rounding
    of the f64 sum is the same in both forms)."""
    return (a.astype(np.float64) - f.astype(np.float64) * x.astype(np.float64)
            ).astype(np.float32)


def _one_thread(P, mask, op):
    """node_blocks_kernel's elimination: [P | I], masked rows the unit row,
    then per pivot i row i / a[i][i] and every row r != i less a[r][i] times
    row i, column by column."""
    N, F = P.shape[0], P.shape[1]
    a = np.concatenate([P, np.broadcast_to(np.eye(F, dtype=np.float32),
                                           P.shape)], axis=2).copy()
    if mask is not None:
        a[:, :, :F] = np.where(mask[:, :, None] != 0, np.eye(F, dtype=np.float32),
                               a[:, :, :F])
    for i in range(F):
        p = a[:, i, i].copy()
        for c in range(2 * F):
            a[:, i, c] = a[:, i, c] / p
        for r in range(F):
            if r == i:
                continue
            f = a[:, r, i].copy()
            for c in range(2 * F):
                a[:, r, c] = op(a[:, r, c], f, a[:, i, c])
    return a[:, :, F:]


def _lanes(P, mask, op):
    """node_build_kernel's elimination: lane j holds a = P[:, j] and b =
    e_j (masked rows: a[i] = (i == j)); per pivot i every lane takes column
    i from lane i (the shuffles, before any lane updates), divides its row
    i by the pivot and subtracts col[r] times row i from each row r != i."""
    N, F = P.shape[0], P.shape[1]
    A = [P[:, :, j].copy() for j in range(F)]            # A[j][:, i]
    B = [np.broadcast_to(np.eye(F, dtype=np.float32)[:, j], (N, F)).copy()
         for j in range(F)]
    if mask is not None:
        for j in range(F):
            A[j] = np.where(mask != 0, np.eye(F, dtype=np.float32)[:, j], A[j])
    for i in range(F):
        col = A[i].copy()                                  # the shuffles
        p = col[:, i]
        for j in range(F):
            a, b = A[j], B[j]
            a[:, i] = a[:, i] / p
            b[:, i] = b[:, i] / p
            for r in range(F):
                if r == i:
                    continue
                a[:, r] = op(a[:, r], col[:, r], a[:, i])
                b[:, r] = op(b[:, r], col[:, r], b[:, i])
    return np.stack(B, axis=2)                            # [N, i, j]


def _blocks(F, groups, n, seed):
    """n diagonally dominant f32 blocks (mass / dt on the diagonal), the
    cross-group entries exact zeros under a field split."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, F, F)).astype(np.float32)
    P += np.float32(4.0 * F) * np.eye(F, dtype=np.float32)
    if groups:
        g = np.zeros(F, int)
        for k, s in enumerate(groups):
            g[s:] = k
        P = np.where(g[:, None] == g[None, :], P, np.float32(0.0))
    return P


@pytest.mark.parametrize("F, form, masked, groups", [
    (2, "exact", False, None), (2, "exact", True, None),
    (2, "contracted", False, None), (3, "contracted", True, None),
    (3, "contracted", False, (0, 2)), (4, "contracted", False, (0, 2)),
    (6, "contracted", False, (0, 2)), (6, "contracted", False, None)])
def test_lane_split_is_the_one_thread_elimination(F, form, masked, groups):
    n = 4000
    P = _blocks(F, groups, n, seed=F * 10 + masked)
    mask = None
    if masked:
        mask = (np.random.default_rng(F).random((n, F)) < 0.3).astype(np.float32)
    op = _exact if form == "exact" else _contracted
    got = _lanes(P, mask, op)
    ref = _one_thread(P, mask, op)
    assert np.isfinite(got).all()
    assert np.array_equal(got, ref)
    if groups:   # the cross-group entries stay exact zeros
        g = np.zeros(F, int)
        for k, s in enumerate(groups):
            g[s:] = k
        assert (got[:, g[:, None] != g[None, :]] == 0).all()
    # and it is the inverse of the (masked) block
    Pm = P.astype(np.float64)
    if mask is not None:
        Pm = np.where(mask[:, :, None] != 0, np.eye(F), Pm)
    np.testing.assert_allclose(got.astype(np.float64) @ Pm,
                               np.broadcast_to(np.eye(F), Pm.shape),
                               atol=1e-5)


# ---- the multigrid build, the launcher, the refusals -------------------------

def test_gmg_build_goes_through_the_plan():
    pb = bench1.make(nx=32, ny=32)
    build = pb.precond_builder("cpu")
    nb = build.node_build
    assert isinstance(nb, NodeBuildPlan)
    assert nb.levels == build.node_blocks
    assert [g.nx for g in nb.grids] == [g.nx for g in build.grids] == [32, 16]
    w = tuple(t.float() for t in pb.initial_state("cpu"))
    calls = []
    real = NodeBuildPlan.__call__

    def recording(self, *args):
        calls.append(args[2])
        return real(self, *args)

    NodeBuildPlan.__call__ = recording
    try:
        _lib.reset_launches()
        build(w, w, 0.01)
        assert calls == [float(np.float32(0.01))]
        assert _lib.ENTRIES["precond_build"] == 1
        assert _lib.LAUNCHES["node_build"] == 0   # CPU tensors: plain
    finally:
        NodeBuildPlan.__call__ = real
        _lib.reset_launches()


class _Recorder:
    """Stands in for the kernel library: records each launcher's name, the
    parameter block (copied out while it is alive) and the other
    arguments."""

    def __init__(self, param_floats):
        self.calls, self.param_floats, self.lib = [], param_floats, self

    def pfh_jvp_param_floats(self):
        return self.param_floats

    def __getattr__(self, name):
        def launcher(params, *args):
            block = np.ctypeslib.as_array((ctypes.c_float * self.param_floats)
                                          .from_address(params)).copy()
            self.calls.append((name, block, args))
            return 0
        return launcher


@pytest.mark.parametrize("name", ["bench1", "bench6", "bench2", "bench3"])
def test_launch_arguments(name, monkeypatch):
    pb, nb = _small(name)
    first = nb.levels[0]
    rec = _Recorder(first._head.size + 1)
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "stream_handle", lambda: 7)
    monkeypatch.setattr(nb, "check", lambda w_, w0_: 0)
    g0 = nb.grids[0]
    w, w0 = _state(pb, g0, 3), _state(pb, g0, 4)
    _lib.reset_launches()
    states, planes = nb.kernel(w, w0, DT)
    assert _lib.LAUNCHES["node_build"] == 1 and _lib.LAUNCHES["node_blocks"] == 0
    _lib.reset_launches()
    ((symbol, block, args),) = rec.calls
    assert symbol == first._symbol.replace("node_blocks", "node_build")
    np.testing.assert_array_equal(block[:-1], first._head)
    assert block[-1] == np.float32(DT)
    nvar = len(first._variant)
    assert args[:nvar] == first._variant
    F, L = nb.F, len(nb.grids)
    assert args[nvar:nvar + 3] == (nb.table.data_ptr(), L, nb.total)
    assert args[nvar + 3:nvar + 7] == tuple(t.data_ptr() for t in w + w0)
    assert args[nvar + 7:nvar + 10] == (
        nb.diag.data_ptr(), None if nb.mask is None else nb.mask.data_ptr(),
        nb.src.data_ptr())
    assert args[-1] == 7
    # the views: the planes and the coarse states in the two allocations
    base_p, base_s = args[nvar + 10], args[nvar + 11]
    for l, (g, (pv, pm)) in enumerate(zip(nb.grids, planes)):
        assert pv.shape == (F, F) + g.vshape and pm.shape == (F, F) + g.mshape
        assert pv.data_ptr() == base_p + 4 * nb.records[l, RECORD.index("planes")]
        assert pm.data_ptr() == pv.data_ptr() + 4 * pv.numel()
        if l == 0:
            assert states[0] == (w, w0)
            continue
        (v, m), (v0, m0) = states[l]
        assert v.data_ptr() == base_s + 4 * nb.records[l, RECORD.index("states")]
        assert (m.data_ptr(), v0.data_ptr(), m0.data_ptr()) == (
            v.data_ptr() + 4 * v.numel(), m.data_ptr() + 4 * m.numel(),
            v0.data_ptr() + 4 * v0.numel())
        assert all(t.is_contiguous() for t in (v, m, v0, m0))


def test_refusals():
    pb, nb = _small("bench1")
    w = _state(pb, nb.grids[0], 5)
    with pytest.raises(ValueError, match="CUDA"):
        nb.kernel(w, w, DT)
    # the levels of one build share the physics
    p6, nb6 = _small("bench6")
    with pytest.raises(ValueError, match="differ"):
        NodeBuildPlan(nb.grids, [nb.levels[0]] + nb6.levels[1:], device="cpu")
    # a pair of unequal ratios has no composed index
    g = nb.grids[0]
    with pytest.raises(NotImplementedError):
        composed_index([g, dataclasses.replace(g, nx=g.nx // 2,
                                               ny=g.ny // 4)])
