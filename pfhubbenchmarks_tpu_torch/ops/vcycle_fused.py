"""Kernel V (``csrc/vcycle_fused.cuh``; ``csrc/vcycle_fused_ch.cu`` at BM1's
physics, ``csrc/vcycle_fused_chac.cu`` at BM2's): one V-cycle apply and its
exported A z in one cooperative launch with a thread-block cluster
dimension.

It replaces ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle``
with ``with_matvec=True`` (TPU row 5), which the JAX package runs where
``fuse_vcycle`` is "auto" and its gate holds (``solve/gmg.py:320-345``):
bench1, bench2 and their variants. ``make_fused_vcycle`` returns
``vcycle(b, w_levels, w0_levels, dt, pinvs) -> (z, A z)`` over every level
of the hierarchy (``w_levels``, ``pinvs``: one per level, the coarsest
included): the descent of ``nu_pre`` sweeps a level (``nu_fine_pre`` on
level 0) and its restrictions, ``coarse_sweeps`` LMR sweeps from zero on
the coarsest level, the ascent of ``nu_post`` sweeps (``nu_fine_post``),
and A z of the result by the exported J.v ``mv_jv`` (the coupled operator
at the outer rule). Three versions:

- ``.kernel``: one launch of V through a ``VcyclePlan`` built with it,
  counted as one ``vcycle_fused`` launch in ``_lib.LAUNCHES``;
- ``.sequence``: the split apply on the card, which V computes the bits
  of: the descend chain kernel, kernel L on the coarsest level (x = 0, r =
  the restricted right-hand side), the ascend chain kernel and the exported
  J.v's kernel (W), each counting its own launches;
- ``.plain``: the same through the plain versions.

The call takes ``.plain`` for CPU tensors and ``.kernel`` otherwise; a V
that cannot build, fit its grid or launch raises, and nothing falls back to
the split apply. ``.descend``, ``.ascend`` and ``.coarse`` are the chains
and the coarsest sweep loop of the split apply (solve/gmg.py's ``Minv``
alone runs them).

The plan fixes, once, which levels run on cluster 0 of the launch and which
on the whole grid (``cluster_from``): the coarsest level runs on a cluster
of ``CLUSTER`` CTAs wherever its work needs at most ``CLUSTER_WORK`` CTAs
(``coarse_on_cluster``), every other level on the grid; a plan with no level
on cluster 0 launches clusters of one CTA, so that its grid is not cut to
whole clusters of 16. The rule and the times it rests on (chip_smoke.py
phase 30) are in PERF.md (row 5).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (_check, _ptr,
                                                        make_ascend_chain,
                                                        make_descend_chain,
                                                        one_launch)

NAME = "vcycle_fused"
# the instantiations: the levels' physics and point count, the matvec's
# (csrc/vcycle_fused_ch.cu: CH at dunavant2 and ffc3; vcycle_fused_chac.cu:
# the field-split CHAC<NE> at dunavant1 and the coupled one at ffc3)
LEVEL_NQ = {"ch": 3, "chac": 1}
MV_NQ = 4
# cudaLaunchAttributeClusterDimension: the CTAs of cluster 0
CLUSTER = 16
# the coarsest level runs on cluster 0 where its phases need at most this
# many CTAs (its nodes over 256 threads, its dot slots), else on the grid:
# on an H100 the cluster won at 11, 14 and 32 CTAs of work (bench1, its
# ragged 37 x 23, bench2 NE 1) and lost at 63 and 155 (NE 2, NE 4)
CLUSTER_WORK = 32
# csrc/vcycle_fused.cuh kV*: the phases one launch runs
PHASES = {"descend": 1, "coarse": 2, "ascend": 4, "matvec": 8}
ALL_PHASES = 15
_N_PTRS = 21  # pfh_vcycle_chain_pack's pointers


def _nodes(g: CrossedTriGrid) -> int:
    return g.n_vertices_y * g.n_vertices_x + g.ny * g.nx


def _ctas(n: int) -> int:
    return -(-n // lmr._LMR_THREADS)


def coarse_on_cluster(coarse_ctas: int) -> bool:
    """The plan's rule: whether the coarsest level, whose phases need
    ``coarse_ctas`` CTAs, runs on cluster 0."""
    return coarse_ctas <= CLUSTER_WORK


class VcyclePlan:
    """V's launch over the hierarchy ``grids`` (levels' gather J.v ``jvs``,
    one per level), fixed when it is built: the descent's sweep counts
    ``pre`` and the ascent's ``post`` (per pair level), ``coarse_sweeps``,
    ``field_groups``, and the exported J.v's launch record ``mv_launch``
    (ops/fem_jvp.GatherLaunch).

    Construction checks that the levels share one physics of V's
    instantiations at its level rule (``LEVEL_NQ``; BM2's levels the
    field-split operator), that the matvec is the same physics' coupled
    operator at the 4-point rule on the fine grid, that no level has
    Dirichlet rows, and that every pair is nested with an equal ratio. At
    the first call on a device it allocates every level's planes (x, r, z,
    A z, and the restricted right-hand side of each pair) in one f32 buffer
    and their f64 partials in another; whenever the states, block planes or
    ``dt`` are other than the last call's it packs the table
    (``pfh_vcycle_chain_pack``: the descent's records, the coarsest's, the
    ascent's; then the matvec's parameter block) and copies it to the
    card."""

    def __init__(self, grids, jvs, mv_launch, *, pre, post, coarse_sweeps: int,
                 field_groups=None):
        K = len(grids) - 1
        if K < 1 or len(jvs) != K + 1 or len(pre) != K or len(post) != K:
            raise ValueError("V needs at least two levels, a J.v per level "
                             "and sweep counts per level pair")
        if not one_launch(jvs):
            raise ValueError("V runs gather levels only")
        first = jvs[0].launch
        if first.kind not in LEVEL_NQ or len(first.dims) != 2:
            raise NotImplementedError(f"{NAME}: no instantiation for the "
                                      f"physics {first.kind!r}")
        if first.nq != LEVEL_NQ[first.kind]:
            raise NotImplementedError(
                f"{NAME}: the {first.kind} levels are built at "
                f"{LEVEL_NQ[first.kind]} points, not {first.nq}")
        if first.kind == "chac" and first.variant[1] != 1:
            raise NotImplementedError(f"{NAME}: BM2's levels run the "
                                      "field-split operator")
        for jv in jvs:
            ln = jv.launch
            if (ln.kind, ln.nq, ln.variant, ln.n_fields) != (
                    first.kind, first.nq, first.variant, first.n_fields):
                raise ValueError(f"{NAME}: the levels differ in physics, "
                                 "point count or fields")
            if ln.mask is not None:
                raise NotImplementedError(f"{NAME}: takes no Dirichlet rows")
        F = first.n_fields
        if (mv_launch.kind != first.kind or mv_launch.nq != MV_NQ
                or mv_launch.mask is not None or mv_launch.n_fields != F
                or mv_launch.dims != (grids[0].ny, grids[0].nx)
                or (first.kind == "chac" and mv_launch.variant
                    != (first.variant[0], 0))):
            raise NotImplementedError(
                f"{NAME}: the exported A z is the levels' physics, coupled, "
                f"at {MV_NQ} points on the fine grid, without Dirichlet rows")
        starts = lmr.group_starts(field_groups)
        if starts is not None and starts[-1] != F:
            raise ValueError(f"field groups {starts} do not cover {F} fields")
        for l, (g, jv) in enumerate(zip(grids, jvs)):
            if g.periodic or g.pad_to != (1, 1):
                raise NotImplementedError(f"{NAME} takes unpadded, "
                                          "non-periodic grids")
            if jv.launch.dims != (g.ny, g.nx):
                raise ValueError(f"level {l}: J.v of {jv.launch.dims} cells "
                                 f"on a {g.ny}x{g.nx} grid")
        self.grids = list(grids)
        self.jvs = list(jvs)
        self.ratios = [kt.equal_ratio(c, f) for f, c in zip(grids, grids[1:])]
        self.pre, self.post = list(pre), list(post)
        self.coarse_sweeps = coarse_sweeps
        self.starts = starts
        self.n_groups = 1 if starts is None else len(starts) - 1
        self.n_fields = F
        self.kind, self.nq = first.kind, first.nq
        self.variant = first.variant[:1]   # chac: NE
        self.mv_head = mv_launch.head
        self.nbs = [lmr.lmr_partial_blocks(F * _nodes(g)) for g in grids]
        self.symbol = "pfh_vcycle_fused_" + first.kind
        # the most CTAs any phase of any level can use: its nodes, its
        # slots, its transfers' (field, node) pairs; the matvec's nodes
        self.need = max(max(_ctas(_nodes(g)), self.n_groups * nb,
                            _ctas(F * _nodes(g)))
                        for g, nb in zip(grids, self.nbs))
        self.coarse_ctas = max(_ctas(_nodes(grids[-1])),
                               self.n_groups * self.nbs[-1])
        on_cluster = coarse_on_cluster(self.coarse_ctas)
        self.cluster_from = K if on_cluster else K + 1
        self.cluster = CLUSTER if on_cluster else 1
        self.grid = 0           # the CTAs of the last launch
        self._dev = None
        self._key = None

    @property
    def K(self) -> int:
        return len(self.grids) - 1

    def shapes(self, g, lead=()):
        F = self.n_fields
        return tuple(torch.Size(lead + (F,) + s) for s in (g.vshape, g.mshape))

    # ---- device state -----------------------------------------------------

    def _allocate(self, dev: torch.device):
        lib = _lib.library()
        if lib.lib.pfh_jvp_param_floats() != self.mv_head.size + 1:
            raise RuntimeError(f"{NAME}: parameter block does not match the "
                               "kernel's JvpParams layout")
        self._lib = lib
        self._fn = getattr(lib.lib, self.symbol)
        self._level_bytes = lib.lib.pfh_vcycle_chain_level_bytes()
        names = [(l, p, g) for l, g in enumerate(self.grids)
                 for p in ("x", "r", "z", "az")]
        names += [(l, "t", g) for l, g in enumerate(self.grids[1:])]
        sizes = [sum(math.prod(s) for s in self.shapes(g)) for _, _, g in names]
        buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        self._planes, off = {}, 0
        for (l, p, g), n in zip(names, sizes):
            pair = []
            for s in self.shapes(g):
                pair.append(buf[off: off + math.prod(s)].view(s))
                off += math.prod(s)
            self._planes[(l, p)] = tuple(pair)
        n_part = [2 * self.n_groups * nb for nb in self.nbs]
        part = torch.empty(sum(n_part), dtype=torch.float64, device=dev)
        self._partials = [part[a: a + n] for a, n in
                          zip(np.cumsum([0] + n_part[:-1]).tolist(), n_part)]
        self._buffers = (buf, part)
        n_rec = 2 * self.K + 1
        self._host = np.zeros(n_rec * self._level_bytes + 4 * (
            self.mv_head.size + 1), np.uint8)
        self._table = torch.empty(self._host.size, dtype=torch.uint8,
                                  device=dev)
        self._dev, self._key = dev, None

    def records(self):
        """The table's records in order, each as ``(level, n_sweeps, R,
        x, b, xin, t)``: the descent's, the coarsest's, the ascent's; planes
        are (level, name) keys of the plan's buffers, 0 a null pair."""
        K = self.K
        out = []
        for l in range(K):
            out.append((l, self.pre[l], self.ratios[l], (l, "x"),
                        0 if l == 0 else (l - 1, "t"), 0, (l, "t")))
        out.append((K, self.coarse_sweeps, 0, (K, "x"), (K - 1, "t"), 0, 0))
        for l in range(K):
            out.append((l, self.post[l], self.ratios[l],
                        0 if l == 0 else (l, "x"),
                        0 if l == 0 else (l - 1, "t"), (l, "x"), 0))
        return out

    def _bind(self, dev, w_levels, pinvs, dt):
        """The device table for these operands: packed and copied only when
        they are other tensors than the last call's, or ``dt`` differs."""
        L = self.K + 1
        key = (dt, *(t for lvl in (w_levels[:L], pinvs[:L]) for p in lvl
                     for t in p))
        if self._key is not None and len(key) == len(self._key) and \
                key[0] == self._key[0] and all(
                    a is b for a, b in zip(key[1:], self._key[1:])):
            return
        for l, g in enumerate(self.grids):
            _check(NAME, w_levels[l], self.shapes(g), dev)
            _check(NAME, pinvs[l], self.shapes(g, (self.n_fields,)), dev)
        P = self._planes

        def pair(k):
            return (0, 0) if k == 0 else P[k]

        n_groups, c_starts = lmr.c_groups(self.starts)
        dtf = np.array([dt], np.float32)
        for i, (l, n, R, x, b, xin, t) in enumerate(self.records()):
            g = self.grids[l]
            gc = self.grids[l + 1] if R else None
            ptrs = [*pair(x), *P[(l, "r")], *P[(l, "z")], *P[(l, "az")],
                    *pinvs[l], *w_levels[l], None, self._partials[l],
                    *pair(b), *pair(xin), *pair(t), None]
            ints = (ctypes.c_int * 9)(self.n_fields, g.ny, g.nx, n,
                                      self.nbs[l], n_groups, R,
                                      gc.ny if gc else 0, gc.nx if gc else 0)
            params = np.concatenate([self.jvs[l].launch.head, dtf])
            weights = None if R in (0, 2) else kt._general_params(R)
            self._lib.call(
                "pfh_vcycle_chain_pack",
                self._host.ctypes.data + i * self._level_bytes,
                params.ctypes.data,
                None if weights is None else weights.ctypes.data,
                (ctypes.c_void_p * _N_PTRS)(*map(_ptr, ptrs)), ints, c_starts)
        mv = np.concatenate([self.mv_head, dtf])
        off = (2 * self.K + 1) * self._level_bytes
        self._host[off:] = mv.view(np.uint8)
        self._table.copy_(torch.from_numpy(self._host))
        self._key = key

    def launch(self, dev, w_levels, pinvs, dt, b, z, az, *,
               cluster_from: int | None = None, cluster: int | None = None,
               phases: int = ALL_PHASES) -> None:
        """One launch of V on ``dev``: z and A z of ``b`` into ``z`` and
        ``az``. ``cluster_from``, ``cluster`` and ``phases`` (``PHASES``
        bits) override the plan's for chip_smoke.py's measurements of one
        phase in either scope; the main path passes none."""
        if self._dev != dev:
            self._allocate(dev)
        self._bind(dev, w_levels, pinvs, dt)
        grid = ctypes.c_int(0)
        err = self._fn(self.nq, MV_NQ, *self.variant, self._table.data_ptr(),
                       self.K, self.need, cluster or self.cluster,
                       self.cluster_from if cluster_from is None
                       else cluster_from, phases,
                       *map(_ptr, (*b, *z, *az)), ctypes.byref(grid),
                       _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.grid = grid.value
        _lib.count_launch(NAME)

    def info(self) -> dict:
        """The instantiation's registers, spills, shared bytes, CTAs per SM
        and co-resident clusters of the plan's cluster size."""
        out = (ctypes.c_int * 6)()
        _lib.library().call(self.symbol + "_info", *self.variant, self.cluster,
                            out)
        return dict(zip(("registers", "local_bytes", "static_smem",
                         "dynamic_smem", "ctas_per_sm", "clusters"), out))


def make_fused_vcycle(grids, jvs, mv_jv, *, nu_pre: int, nu_post: int,
                      nu_fine_pre: int = 0, nu_fine_post: int = 0,
                      coarse_sweeps: int, field_groups=None):
    """``jvs[l]``: level l's gather J.v (every level, the coarsest
    included); ``mv_jv``: the exported J.v (ops/fem_jvp.make_fem_jvp, or
    the box form over one, ops/tri_box.make_box_jvp). ``vcycle.plan`` is
    V's ``VcyclePlan``."""
    K = len(grids) - 1
    pre = [(nu_fine_pre or nu_pre) if l == 0 else nu_pre for l in range(K)]
    post = [(nu_fine_post or nu_post) if l == 0 else nu_post for l in range(K)]
    descend = make_descend_chain(grids, jvs, nu=nu_pre, nu_fine=nu_fine_pre,
                                 field_groups=field_groups)
    ascend = make_ascend_chain(grids, jvs, nu=nu_post, nu_fine=nu_fine_post,
                               field_groups=field_groups)
    coarse = lmr.make_level_sweep_loop(jvs[K], coarse_sweeps, field_groups)
    plan = VcyclePlan(grids, jvs, getattr(mv_jv, "gather", mv_jv).launch,
                      pre=pre, post=post, coarse_sweeps=coarse_sweeps,
                      field_groups=field_groups)

    def split(version, b, w_levels, w0_levels, dt, pinvs):
        v = "kernel" if version == "sequence" else "plain"
        xs, bs, bc = getattr(descend, v)(b, w_levels[:K], w0_levels[:K], dt,
                                         pinvs[:K])
        x = tuple(t.new_zeros(t.shape) for t in bc)
        r = tuple(t.clone() for t in bc)
        getattr(coarse, v)(x, r, w_levels[K], w0_levels[K], dt, *pinvs[K])
        z = getattr(ascend, v)([b] + bs, xs, x, w_levels[:K], w0_levels[:K],
                               dt, pinvs[:K])
        return z, getattr(mv_jv, v)(w_levels[0], w0_levels[0], dt, z)

    def kernel(b, w_levels, w0_levels, dt, pinvs):
        del w0_levels  # the tangents do not read the previous time level
        dev = _check(NAME, b, plan.shapes(grids[0]))
        F = plan.n_fields
        g = grids[0]
        nv, nm = F * g.vshape[0] * g.vshape[1], F * g.mshape[0] * g.mshape[1]
        out = torch.empty(2 * (nv + nm), dtype=torch.float32, device=dev)
        zv, zm, av, am = out.split((nv, nm, nv, nm))
        vs, ms = plan.shapes(g)
        z, az = (zv.view(vs), zm.view(ms)), (av.view(vs), am.view(ms))
        plan.launch(dev, w_levels, pinvs, dt, b, z, az)
        return z, az

    def vcycle(b, w_levels, w0_levels, dt, pinvs):
        if _lib.on_cpu(b[0]):
            return split("plain", b, w_levels, w0_levels, dt, pinvs)
        return kernel(b, w_levels, w0_levels, dt, pinvs)

    vcycle.kernel = kernel
    vcycle.plain = lambda *a: split("plain", *a)
    vcycle.sequence = lambda *a: split("sequence", *a)
    vcycle.plan = plan
    vcycle.descend, vcycle.ascend, vcycle.coarse = descend, ascend, coarse
    return vcycle
