"""The V-cycle's level steps and the chains built from them: kernels
``vcycle_descend_chain`` and ``vcycle_ascend_chain`` (``csrc/vcycle_chain.cuh``).

The level steps replace ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:
make_fused_descend`` and ``make_fused_ascend`` (one Pallas call per level
pair on the TPU, ``fuse_vcycle='split_levels'``), with the same signatures
and outputs:

- ``descend(b, w, w0, dt, pinv) -> (x, bc)``: ``nu`` LMR sweeps from x = 0
  on ``b`` at the fine level, then the Galerkin restriction of the smoothed
  residual with the coarse Dirichlet rows zeroed.
- ``ascend(b, x, xc, w, w0, dt, pinv) -> z``: ``x + P xc`` (nothing added
  on the fine Dirichlet rows), ``r = b - A x`` in one J.v launch, ``nu``
  LMR sweeps.

The chains replace ``make_fused_descend_chain`` and ``make_fused_ascend_chain``
(``fuse_vcycle='split_chain'``, one Pallas call each):

- ``descend_chain(b, w_levels, w0_levels, dt, pinvs) -> (xs, bs, bc)``: the
  descent of every level l < K (K = len(grids) - 1); ``xs`` are the smoothed
  iterates, ``bs`` the restricted right-hand sides of levels 1..K-1, ``bc``
  the coarsest's.
- ``ascend_chain(bs, xs, xc, w_levels, w0_levels, dt, pinvs) -> z``: the
  ascent from the coarsest correction ``xc`` up through levels K-1..0;
  ``bs[0]`` is the fine right-hand side.

``nu_fine`` (0: ``nu``) is the sweep count of level 0. ``field_groups``
are the sweeps' (ops/lmr.make_lmr_sweep_loop): the in-group block-Jacobi
planes and one LMR step length per group of a field-split cycle (BM2).

Each step and chain has three versions:

- ``.kernel``: one launch of the chain kernel over all of its levels (a
  level step is a chain of one level), through a ``ChainPlan`` built with
  it; counted as one ``vcycle_descend_chain`` or ``vcycle_ascend_chain``
  launch in ``_lib.LAUNCHES`` (at the anisotropic BM3's physics "acha" as
  ``vcycle_descend_chain_acha`` or ``vcycle_ascend_chain_acha``). It needs
  every level to be a gather level
  (a J.v with ``jv.launch``, ops/fem_jvp.GatherLaunch), all of one physics
  and point count.
- ``.sequence``: the launch sequence per level of the sweep loop (kernel L,
  or on a level routed to the tile kernels the tiled loop of TS and C,
  ops/lmr.make_level_sweep_loop), the pair's transfer (a plan built once
  with the step, ops/transfer.TransferPlan: kernel D for a dyadic pair, H
  for an equal odd ratio, with the Dirichlet masks) and on the ascent the
  level J.v (T12 on a tiled level); counted as one ``descend_level``,
  ``ascend_level``, ``descend_chain`` or ``ascend_chain`` call in
  ``_lib.CALLS``, the kernels inside counting their own. The chain kernels
  compute its bits.
- ``.plain``: the same sequence through the plain versions.

Calling a step or chain takes ``.plain`` for CPU tensors; on the card
``.kernel`` where every level is a gather level (``.one_launch``) and
``.sequence`` otherwise: the opt-in tiled configuration, whose routed levels
sweep with TS and C. The choice is made once, from the levels, when the
chain is built; a chain kernel that cannot build, fit its grid or launch
raises.

The descent's ``.kernel`` returns the plan's own buffers: its outputs hold
until the next call of the same chain's ``.kernel``. The ascent returns a
new ``z`` (the Krylov solver keeps each one).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt

_KINDS = ("ch", "chp", "chac", "ach", "acha")   # the physics the chain kernels take
_N_PTRS = 21                            # pfh_vcycle_chain_pack's pointers


@dataclasses.dataclass(frozen=True)
class ChainLevel:
    """One level of a chain as its launch takes it (``csrc/vcycle_chain.cuh``
    ChainLevel), the pair being (``fine``, ``coarse``): ``jv`` the level
    J.v, whose ``jv.launch`` gives the physics, the parameter block without
    dt (``head``) and the Dirichlet mask of the sweeps and the residual
    (``sweep_mask``); ``n_sweeps``; ``nb`` the slots per group and
    ``starts`` the field groups' starts (kernel L's, ops/lmr.py); ``R`` the
    pair's ratio (2: kernel D's bodies, 3, 5, 7: H's, with its class tables
    ``weights``); ``transfer_mask`` the Dirichlet mask of the transfer's
    output grid (the coarse grid's on the descent, the fine grid's on the
    ascent) or None."""

    fine: CrossedTriGrid
    coarse: CrossedTriGrid
    jv: object
    n_sweeps: int
    nb: int
    starts: tuple[int, ...] | None
    R: int
    head: np.ndarray
    weights: np.ndarray | None
    sweep_mask: torch.Tensor | None
    transfer_mask: torch.Tensor | None

    @property
    def n_fields(self) -> int:
        return self.jv.n_fields

    def params(self, dt: float) -> np.ndarray:
        """The J.v's parameter block with ``dt``, as its launch takes it
        (ops/fem_jvp.with_dt)."""
        return np.concatenate([self.head, np.array([dt], np.float32)])

    def shapes(self, g: CrossedTriGrid, lead=()):
        F = self.n_fields
        return tuple(torch.Size(lead + (F,) + s) for s in (g.vshape, g.mshape))


def _nodes(g: CrossedTriGrid) -> int:
    return g.n_vertices_y * g.n_vertices_x + g.ny * g.nx


def one_launch(jvs) -> bool:
    """Whether levels with these J.v all run the gather kernels (``jv.launch``
    and no tile-kernel route), so their chain is one launch."""
    return all(getattr(jv, "launch", None) is not None
               and getattr(jv, "tile_sweep", None) is None for jv in jvs)


class ChainPlan:
    """The launch of one chain kernel over the pairs (grids[l], grids[l+1]),
    l < K, fixed when it is built: ``levels`` (ChainLevel) from the J.v
    ``jvs``, the sweep counts ``counts``, the vertex masks ``masks`` (per
    grid, or None) and ``field_groups``; ``ascend`` picks the kernel.

    Construction checks that the levels share one physics of the chain
    kernels, point count, variant and field count, and that every pair is
    nested with an equal ratio (ops/transfer.equal_ratio). At the first call
    on a device the plan allocates every level's scratch (r, z, A z and the
    f64 partials, and the descent's outputs) in two buffers, and whenever
    the states, block planes, ``dt`` or the ascent's inputs are other
    tensors than the last call's it packs the levels' records
    (``pfh_vcycle_chain_pack``) and copies them to the card."""

    def __init__(self, grids, jvs, counts, masks, field_groups, *,
                 ascend: bool):
        K = len(grids) - 1
        if K < 1 or len(jvs) < K or len(counts) != K:
            raise ValueError("a chain needs at least two levels, a J.v and a "
                             "sweep count per level pair")
        if not one_launch(jvs[:K]):
            raise ValueError("a chain kernel runs gather levels only; a "
                             "chain with tiled levels runs its sequence")
        first = jvs[0].launch
        if first.kind not in _KINDS or len(first.dims) != 2:
            raise NotImplementedError(f"the chain kernels take the 2D physics "
                                      f"{_KINDS}, not {first.kind!r}")
        for jv in jvs[1:K]:
            ln = jv.launch
            if (ln.kind, ln.nq, ln.variant, ln.n_fields) != (
                    first.kind, first.nq, first.variant, first.n_fields):
                raise ValueError(
                    "a chain kernel runs one physics at one point count: "
                    f"levels of {first.kind} nq={first.nq} {first.variant} "
                    f"F={first.n_fields} and {ln.kind} nq={ln.nq} "
                    f"{ln.variant} F={ln.n_fields}")
        masks = masks or [None] * len(grids)
        starts = lmr.group_starts(field_groups)
        F = first.n_fields
        if starts is not None and starts[-1] != F:
            raise ValueError(f"field groups {starts} do not cover {F} fields")
        self.levels = []
        for l in range(K):
            fine, coarse = grids[l], grids[l + 1]
            R = kt.equal_ratio(coarse, fine)
            for g in (fine, coarse):
                if g.periodic or g.pad_to != (1, 1):
                    raise NotImplementedError("a chain takes unpadded, "
                                              "non-periodic grids")
            if jvs[l].launch.dims != (fine.ny, fine.nx):
                raise ValueError(f"level {l}: J.v of {jvs[l].launch.dims} "
                                 f"cells on a {fine.ny}x{fine.nx} grid")
            self.levels.append(ChainLevel(
                fine=fine, coarse=coarse, jv=jvs[l], n_sweeps=counts[l],
                nb=lmr.lmr_partial_blocks(F * _nodes(fine)), starts=starts,
                R=R, head=jvs[l].launch.head,
                weights=None if R == 2 else kt._general_params(R),
                sweep_mask=jvs[l].launch.mask,
                transfer_mask=masks[l] if ascend else masks[l + 1]))
        self.ascend = ascend
        self.kind, self.nq, self.variant = first.kind, first.nq, first.variant
        self.n_fields = F
        self.n_groups = 1 if starts is None else len(starts) - 1
        self.symbol = "pfh_vcycle_chain_" + first.kind
        self.kernel_name = _lib.counter(
            "vcycle_ascend_chain" if ascend else "vcycle_descend_chain",
            first.kind)
        # the most CTAs any phase of any level can use: its nodes, its
        # slots, its transfer's (field, output node) pairs
        # (a CTA is kernel L's, csrc/lmr_loop.cuh kLoopThreads)
        T = lmr._LMR_THREADS
        self.need = max(max(-(-_nodes(lv.fine) // T), self.n_groups * lv.nb,
                            -(-F * _nodes(lv.fine if ascend else lv.coarse)
                              // T))
                        for lv in self.levels)
        self.grid = 0           # the CTAs of the last launch
        self._dev = None
        self._key = None

    @property
    def K(self) -> int:
        return len(self.levels)

    # ---- device state -----------------------------------------------------

    def _allocate(self, dev: torch.device):
        """Every level's planes in one f32 buffer (the descent: x, r, z, A z
        and the restricted right-hand side; the ascent: x above level 0, r,
        z, A z) and its partials in one f64 buffer; the table; the views."""
        lib = _lib.library()
        if lib.lib.pfh_jvp_param_floats() != self.levels[0].head.size + 1:
            raise RuntimeError(f"{self.kernel_name}: parameter block does not "
                               "match the kernel's JvpParams layout")
        self._lib = lib
        self._fn = getattr(lib.lib, self.symbol)
        self._level_bytes = lib.lib.pfh_vcycle_chain_level_bytes()
        names = []
        for l, lv in enumerate(self.levels):
            planes = ["x", "r", "z", "az"]
            if self.ascend and l == 0:
                planes = planes[1:]
            names += [(l, p, lv.fine) for p in planes]
            if not self.ascend:
                names.append((l, "t", lv.coarse))
        sizes = [sum(math.prod(s) for s in self.levels[0].shapes(g))
                 for _, _, g in names]
        buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        self._planes, off = {}, 0
        for (l, p, g), n in zip(names, sizes):
            pair = []
            for s in self.levels[0].shapes(g):
                pair.append(buf[off: off + math.prod(s)].view(s))
                off += math.prod(s)
            self._planes[(l, p)] = tuple(pair)
        n_part = [2 * self.n_groups * lv.nb for lv in self.levels]
        part = torch.empty(sum(n_part), dtype=torch.float64, device=dev)
        self._partials = [part[a: a + n] for a, n in
                          zip(np.cumsum([0] + n_part[:-1]).tolist(), n_part)]
        self._buffers = (buf, part)
        self._table = torch.empty(self.K * self._level_bytes,
                                  dtype=torch.uint8, device=dev)
        self._host = np.zeros(self.K * self._level_bytes, np.uint8)
        if not self.ascend:
            self.xs = [self._planes[(l, "x")] for l in range(self.K)]
            self.bs = [self._planes[(l, "t")] for l in range(self.K - 1)]
            self.bc = self._planes[(self.K - 1, "t")]
        self._dev, self._key = dev, None

    def _bind(self, dev, w_levels, pinvs, dt, xs=None, bs=None):
        """The device table for these operands: packed and copied only when
        they are other tensors than the last call's, or ``dt`` differs."""
        key = (dt, *(t for lvl in (w_levels[:self.K], pinvs[:self.K],
                                   xs or (), bs or ()) for p in lvl for t in p))
        if self._key is not None and len(key) == len(self._key) and \
                key[0] == self._key[0] and all(
                    a is b for a, b in zip(key[1:], self._key[1:])):
            return
        name = self.kernel_name
        for l, lv in enumerate(self.levels):
            _check(name, w_levels[l], lv.shapes(lv.fine), dev)
            _check(name, pinvs[l], lv.shapes(lv.fine, (lv.n_fields,)), dev)
            if self.ascend and l > 0:
                _check(name, bs[l - 1], lv.shapes(lv.fine), dev)
            if self.ascend:
                _check(name, xs[l], lv.shapes(lv.fine), dev)
            for m in (lv.sweep_mask, lv.transfer_mask):
                if m is not None:
                    _check(name, (m,), (m.shape,), dev)
        for l, lv in enumerate(self.levels):
            P = self._planes
            x = (0, 0) if self.ascend and l == 0 else P[(l, "x")]
            if self.ascend:
                b = (0, 0) if l == 0 else bs[l - 1]
                xin, t = xs[l], (0, 0)
            else:
                b = (0, 0) if l == 0 else P[(l - 1, "t")]
                xin, t = (0, 0), P[(l, "t")]
            ptrs = [*x, *P[(l, "r")], *P[(l, "z")], *P[(l, "az")], *pinvs[l],
                    *w_levels[l], lv.sweep_mask, self._partials[l], *b, *xin,
                    *t, lv.transfer_mask]
            n_groups, c_starts = lmr.c_groups(lv.starts)
            ints = (ctypes.c_int * 9)(lv.n_fields, lv.fine.ny, lv.fine.nx,
                                      lv.n_sweeps, lv.nb, n_groups, lv.R,
                                      lv.coarse.ny, lv.coarse.nx)
            params = lv.params(dt)
            self._lib.call(
                "pfh_vcycle_chain_pack",
                self._host.ctypes.data + l * self._level_bytes,
                params.ctypes.data,
                None if lv.weights is None else lv.weights.ctypes.data,
                (ctypes.c_void_p * _N_PTRS)(*map(_ptr, ptrs)), ints, c_starts)
        self._table.copy_(torch.from_numpy(self._host))
        self._key = key

    def launch(self, dev, w_levels, pinvs, dt, b, xc=None, z=None, xs=None,
               bs=None) -> None:
        """One launch on ``dev`` (the descent with ``b``; the ascent with
        ``b``, ``xc``, ``z``, ``xs``, ``bs``)."""
        if self._dev != dev:
            self._allocate(dev)
        self._bind(dev, w_levels, pinvs, dt, xs, bs)
        grid = ctypes.c_int(0)
        io = (*b, *(xc or (0, 0)), *(z or (0, 0)))
        err = self._fn(int(self.ascend), self.nq, *self.variant,
                       self._table.data_ptr(), self.K, self.need,
                       *map(_ptr, io), ctypes.byref(grid), _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.grid = grid.value
        _lib.count_launch(self.kernel_name)

    def info(self) -> dict:
        """The instantiation's registers, spills, shared bytes and CTAs per
        SM (``pfh_vcycle_chain_*_info``)."""
        return _lib.library().kernel_info(self.symbol + "_info",
                                          int(self.ascend), self.nq,
                                          *self.variant)


def _ptr(t) -> int | None:
    """A tensor's device pointer; 0 and None stand for a null pointer."""
    if t is None or isinstance(t, int):
        return t or None
    return t.data_ptr()


def _check(name, pair, shapes, dev=None):
    """Raises unless ``pair`` are contiguous float32 CUDA tensors of
    ``shapes`` on ``dev`` (the first's device without it); returns that
    device."""
    _lib.check_cuda(name, list(pair))
    dev = dev or pair[0].device
    if tuple(t.shape for t in pair) != tuple(shapes) or any(
            t.device != dev for t in pair):
        raise ValueError(f"{name}: shapes {[tuple(t.shape) for t in pair]} "
                         f"on {[str(t.device) for t in pair]}, expected "
                         f"{[tuple(s) for s in shapes]} on {dev}")
    return dev


def _version(name, body, kernel, probe):
    """``body(version, *args)`` as ``.plain`` and ``.sequence`` (counted as
    one ``name`` call), ``kernel`` (None where the levels are not all
    gather levels); the call routes by the device of ``probe(args)``."""
    one = kernel is not None
    def sequence(*args):
        out = body("sequence", *args)
        _lib.count_call(name)
        return out

    def plain(*args):
        return body("plain", *args)

    def unavailable(*args):
        raise NotImplementedError(f"{name}: its levels are not all gather "
                                  "levels, so it runs as its sequence")

    def step(*args):
        if _lib.on_cpu(probe(args)):
            return plain(*args)
        return (kernel if one else sequence)(*args)

    step.kernel = kernel if one else unavailable
    step.sequence, step.plain, step.one_launch = sequence, plain, one
    step.plan = getattr(kernel, "plan", None)
    return step


def _descend_kernel(plan):
    def kernel(b, w_levels, w0_levels, dt, pinvs):
        del w0_levels  # the tangents do not read the previous time level
        lv = plan.levels[0]
        dev = _check(plan.kernel_name, b, lv.shapes(lv.fine))
        plan.launch(dev, w_levels, pinvs, dt, b)
        return list(plan.xs), list(plan.bs), plan.bc

    kernel.plan = plan
    return kernel


def _ascend_kernel(plan):
    def kernel(bs, xs, xc, w_levels, w0_levels, dt, pinvs):
        del w0_levels
        lv, top = plan.levels[0], plan.levels[-1]
        dev = _check(plan.kernel_name, bs[0], lv.shapes(lv.fine))
        _check(plan.kernel_name, xc, top.shapes(top.coarse), dev)
        z = tuple(torch.empty(s, dtype=torch.float32, device=dev)
                  for s in lv.shapes(lv.fine))
        plan.launch(dev, w_levels, pinvs, dt, bs[0], xc, z, xs, bs[1:])
        return z

    kernel.plan = plan
    return kernel


def _sweep_version(version):
    """The version of the sweeps, transfers and J.v that a step's
    ``version`` runs: the kernels for its sequence."""
    return "kernel" if version == "sequence" else version


def make_descend_level(fine, coarse, jv, *, nu: int, mask_coarse=None,
                       field_groups=None):
    """``jv``: the fine level's J.v (ops/fem_jvp.make_fem_jvp or
    ops/fem_tile.make_tile_jvp, with its Dirichlet rows and ``n_fields``);
    ``mask_coarse``: the coarse grid's Dirichlet vertex mask tensor or None
    (fem/assembly.bc_mask)."""
    sweep = lmr.make_level_sweep_loop(jv, nu, field_groups)
    restrict = kt.TransferPlan(coarse, fine, jv.n_fields, "restrict",
                               mask_coarse)

    def body(version, b, w, w0, dt, pinv):
        v = _sweep_version(version)
        x = tuple(t.new_zeros(t.shape) for t in b)
        r = tuple(t.clone() for t in b)
        getattr(sweep, v)(x, r, w, w0, dt, *pinv)
        return x, getattr(restrict, v)(r)

    kernel = None
    if one_launch([jv]):
        chain = _descend_kernel(ChainPlan([fine, coarse], [jv], [nu],
                                          [None, mask_coarse], field_groups,
                                          ascend=False))

        def kernel(b, w, w0, dt, pinv):
            xs, _, bc = chain(b, [w], [w0], dt, [pinv])
            return xs[0], bc

        kernel.plan = chain.plan
    return _version("descend_level", body, kernel, lambda a: a[0][0])


def make_ascend_level(fine, coarse, jv, *, nu: int, mask_fine=None,
                      field_groups=None):
    """``mask_fine``: the fine grid's Dirichlet vertex mask tensor or None;
    the rest as for ``make_descend_level``."""
    sweep = lmr.make_level_sweep_loop(jv, nu, field_groups)
    prolong = kt.TransferPlan(coarse, fine, jv.n_fields, "prolong", mask_fine)

    def body(version, b, x, xc, w, w0, dt, pinv):
        v = _sweep_version(version)
        x = tuple(t.clone() for t in x)
        getattr(prolong, v)(xc, x)
        r = getattr(jv, v)(w, w0, dt, x, b=b)
        getattr(sweep, v)(x, r, w, w0, dt, *pinv)
        return x

    kernel = None
    if one_launch([jv]):
        chain = _ascend_kernel(ChainPlan([fine, coarse], [jv], [nu],
                                         [mask_fine, None], field_groups,
                                         ascend=True))

        def kernel(b, x, xc, w, w0, dt, pinv):
            return chain([b], [x], xc, [w], [w0], dt, [pinv])

        kernel.plan = chain.plan
    return _version("ascend_level", body, kernel, lambda a: a[0][0])


def _level_args(grids, masks, nu, nu_fine):
    """Per level pair l: the sweep count and the (fine, coarse) masks."""
    if len(grids) < 2:
        raise ValueError("a chain needs at least two levels")
    masks = masks or [None] * len(grids)
    return [((nu_fine or nu) if l == 0 else nu, masks[l], masks[l + 1])
            for l in range(len(grids) - 1)]


def make_descend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                       field_groups=None):
    """``jvs[l]``: level l's J.v; ``masks[l]``: level l's Dirichlet vertex
    mask tensor or None. ``chain.plan`` is the kernel's ChainPlan (None where
    the chain runs its sequence)."""
    args = _level_args(grids, masks, nu, nu_fine)
    steps = [make_descend_level(grids[l], grids[l + 1], jvs[l], nu=n,
                                mask_coarse=mc, field_groups=field_groups)
             for l, (n, _, mc) in enumerate(args)]
    K = len(steps)

    def body(version, b, w_levels, w0_levels, dt, pinvs):
        xs, bs = [], []
        for l in range(K):
            x, b = getattr(steps[l], version)(b, w_levels[l], w0_levels[l], dt,
                                              pinvs[l])
            xs.append(x)
            if l + 1 < K:
                bs.append(b)
        return xs, bs, b

    kernel = None
    if one_launch(jvs[:K]):
        kernel = _descend_kernel(ChainPlan(grids, jvs, [a[0] for a in args],
                                           masks, field_groups, ascend=False))
    return _version("descend_chain", body, kernel, lambda a: a[0][0])


def make_ascend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                      field_groups=None):
    """Arguments as for ``make_descend_chain``."""
    args = _level_args(grids, masks, nu, nu_fine)
    steps = [make_ascend_level(grids[l], grids[l + 1], jvs[l], nu=n,
                               mask_fine=mf, field_groups=field_groups)
             for l, (n, mf, _) in enumerate(args)]

    def body(version, bs, xs, xc, w_levels, w0_levels, dt, pinvs):
        for l in range(len(steps) - 1, -1, -1):
            xc = getattr(steps[l], version)(bs[l], xs[l], xc, w_levels[l],
                                            w0_levels[l], dt, pinvs[l])
        return xc

    kernel = None
    if one_launch(jvs[:len(steps)]):
        kernel = _ascend_kernel(ChainPlan(grids, jvs, [a[0] for a in args],
                                          masks, field_groups, ascend=True))
    return _version("ascend_chain", body, kernel, lambda a: a[2][0])
