"""Kernel N (``csrc/node_blocks.cuh``, one source per physics
``csrc/node_blocks_{ch,chp,chac,ach}.cu``): the node-block-Jacobi inverses
of one 2D multigrid level in one launch, over its vertex and cell-centre
grids.

It replaces no TPU kernel: the JAX package builds these blocks with
``jax.jvp`` in XLA (``pfhubbenchmarks_tpu/solve/precond.py:
make_block_jacobi``), outside any Pallas kernel. It computes what
``solve/precond.make_block_jacobi`` computes, from the physics' hand-written
pointwise tangent (``Phys::tangent``, the one every J.v kernel runs) with
one-hot directions, and inverts each block in registers by the no-pivot
Gauss-Jordan of ``solve/precond.small_inv``.

``NodeBlockPlan`` is built once per level when the cycle is made
(solve/gmg.py), as ops/transfer.TransferPlan is per level pair. From the
level's gather J.v it takes what its launcher receives (``jv.launch``:
the physics, the parameter head with the constants, the variant, the
Dirichlet vertex mask) and the hand-written tangent (``jv.tangent``), and
fixes once the padded node diagonals (one [3, nvert + ncell] tensor), the
shapes and the launcher. ``plan(w, w0, dt) -> (pv, pm)``, the [F, F, Y, X]
planes that kernels B, L and the chain kernels read, runs the plain version
for CPU tensors and the kernel otherwise; a tensor the kernel does not take
raises, and nothing falls back. ``.plain`` is
``solve/precond.make_block_jacobi_tangent``, the hand-written tangent with
one-hot directions; ``.library`` the ``torch.func.jvp`` build
(``make_block_jacobi``), which no main path calls.

``NodeBuildPlan`` is the whole multigrid build of a 2D hierarchy in one
launch of N's one-launch form (``node_build_kernel``, counted as
``node_build``): every level's planes, and the coarse levels' injected
``(w, w0)`` states, each coarse node copied from the finest level's node
that the chained injections reach (``composed_index``). It is built once
per hierarchy from the levels' ``NodeBlockPlan`` s and fixes the levels'
records in a device table (``RECORD``). ``plan(w, w0, dt) -> (states,
planes)`` runs the plain version for CPU tensors (each level's plain
planes and the chained injections, ops/transfer.TransferPlan) and the
kernel otherwise, which writes every level's planes and states into views
of two allocations; ``.sequence`` is the per-level launches of N and the
injections that it replaces, its comparison on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import MAX_CONST
from pfhubbenchmarks_tpu_torch.ops.transfer import TransferPlan, equal_ratio
from pfhubbenchmarks_tpu_torch.solve.precond import (make_block_jacobi,
                                                     make_block_jacobi_tangent,
                                                     padded_diagonals)

NAME = "node_blocks"
KINDS = ("ch", "chp", "chac", "ach")
# physics whose blocks another instantiation builds: the anisotropic BM3's
# ("acha") are built at zero state gradient, where its a(theta) is 1 and
# a'(theta) 0 with zero tangent (the JAX package's double where), so they
# are the isotropic "ach" blocks; its constants begin with ach's, which are
# all ach's kernel reads (tests/test_torch_bench3_aniso.py holds the JAX
# package's anisotropic and isotropic planes equal)
BUILT_AS = {"acha": "ach"}


class NodeBlockPlan:
    """Kernel N's launch for one level ``grid``, fixed when it is built.
    ``jv`` is the level's gather J.v (ops/fem_jvp.make_fem_jvp: ``.launch``
    and ``.tangent``), ``terms`` the weak form it linearizes (the library
    build's), ``dirichlet`` the level's ``DirichletBC`` rows (those of
    ``jv.launch.mask``)."""

    def __init__(self, grid: CrossedTriGrid, jv, terms, *,
                 device: torch.device | str, dirichlet=()):
        launch = jv.launch
        kind = BUILT_AS.get(launch.kind, launch.kind)
        if kind not in KINDS:
            raise NotImplementedError(f"{NAME}: no instantiation for the "
                                      f"physics {launch.kind!r}")
        if launch.dims != (grid.ny, grid.nx):
            raise ValueError(f"{NAME}: J.v of {launch.dims}, grid "
                             f"{(grid.ny, grid.nx)}")
        F = launch.n_fields
        self.grid, self.F = grid, F
        self.shapes = (torch.Size((F,) + grid.vshape),
                       torch.Size((F,) + grid.mshape))
        self.nvert, self.ncell = math.prod(grid.vshape), math.prod(grid.mshape)
        self.diag = torch.stack([torch.cat([v.reshape(-1), m.reshape(-1)])
                                 for v, m in padded_diagonals(grid, device)])
        self.mask = launch.mask
        if self.mask is not None and (self.mask.shape != self.shapes[0]
                                      or self.mask.dtype != torch.float32
                                      or not self.mask.is_contiguous()):
            raise ValueError(f"{NAME}: the mask must be a contiguous float32 "
                             f"{tuple(self.shapes[0])} tensor")
        self._head, self._variant = launch.head, launch.variant
        self._symbol = f"pfh_{NAME}_{kind}"
        self._plain = make_block_jacobi_tangent(grid, jv.tangent, F,
                                                device=device,
                                                dirichlet=dirichlet)
        self._terms, self._dirichlet, self._device = terms, dirichlet, device
        self._library = None
        self._fn, self._dev = None, None

    def __call__(self, w, w0, dt):
        return (self.plain if w[0].is_cpu else self.kernel)(w, w0, dt)

    def plain(self, w, w0, dt):
        return self._plain(w, w0, dt).pinv_planes

    def library(self, w, w0, dt):
        """The ``torch.func.jvp`` build of the same planes (built at its
        first call)."""
        if self._library is None:
            self._library = make_block_jacobi(
                self.grid, self._terms, self.F, device=self._device,
                dirichlet=self._dirichlet)
        return self._library(w, w0, dt).pinv_planes

    def check(self, w) -> int:
        """The CUDA device index of ``w``; raises unless both planes are
        contiguous float32 CUDA tensors of the level's shapes on the device
        of the diagonals (and the mask)."""
        dev = w[0].get_device()
        for t, shape in zip(w, self.shapes):
            if not t.is_cuda:
                raise ValueError(f"{NAME}: kernel needs CUDA tensors, got "
                                 f"{t.device}")
            if t.dtype != torch.float32:
                raise ValueError(f"{NAME}: dtype {t.dtype}, kernel takes "
                                 "torch.float32")
            if not t.is_contiguous():
                raise ValueError(f"{NAME}: non-contiguous tensor")
            if t.shape != shape:
                raise ValueError(f"{NAME}: shape {tuple(t.shape)}, expected "
                                 f"{tuple(shape)}")
            if t.get_device() != dev:
                raise ValueError(f"{NAME}: tensors on {t.device} and cuda:{dev}")
        for t in (self.diag, self.mask):
            if t is not None and t.get_device() != dev:
                raise ValueError(f"{NAME}: the plan's tensors are on "
                                 f"{t.device}, the state on cuda:{dev}")
        return dev

    def _bind(self, dev: int):
        """The C launcher, resolved once, and the parameter layout checked
        once."""
        lib = _lib.library()
        if self._head.size + 1 != lib.lib.pfh_jvp_param_floats():
            raise RuntimeError(f"{NAME}: parameter block does not match the "
                               "kernel's JvpParams layout")
        self._fn, self._dev = getattr(lib.lib, self._symbol), dev
        return self._fn

    def kernel(self, w, w0, dt):
        del w0  # the tangents do not read the previous time level
        dev = self.check(w)
        fn = self._fn if dev == self._dev else self._bind(dev)
        params = np.append(self._head, np.float32(dt))
        F2 = self.F * self.F
        out = w[0].new_empty(F2 * (self.nvert + self.ncell))
        pv = out[: F2 * self.nvert].view(self.F, *self.shapes[0])
        pm = out[F2 * self.nvert:].view(self.F, *self.shapes[1])
        err = fn(params.ctypes.data, *self._variant, w[0].data_ptr(),
                 w[1].data_ptr(), self.diag.data_ptr(),
                 None if self.mask is None else self.mask.data_ptr(),
                 pv.data_ptr(), pm.data_ptr(), self.nvert, self.ncell,
                 _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self._symbol}: CUDA error {err} at launch")
        _lib.count_launch(NAME)
        return pv, pm

    def info(self) -> dict:
        """Registers, spills and CTAs per SM of this plan's instantiation
        (``_lib.KernelLibrary.kernel_info``)."""
        return _lib.library().kernel_info(f"{self._symbol}_info",
                                          *self._variant)


# ---------------------------------------------------------------------------
# the one-launch build over every level of a hierarchy
# ---------------------------------------------------------------------------

BUILD_NAME = "node_build"
# a level's record in the device table (csrc/node_blocks.cuh kBuildRecord):
# its node counts, its first node in the launch, then the offsets of its
# diagonals, mask, composed index, planes and states (-1: none)
RECORD = ("nvert", "ncell", "first", "diag", "mask", "src", "planes",
          "states")


def composed_index(grids) -> list[np.ndarray | None]:
    """Per level of ``grids`` (finest first), the node of the finest level
    that the chained state injections copy into each of its nodes (vertices
    then centres, row-major), as an index into the finest level's vertices
    then centres; None for the finest level. A coarse vertex is the fine
    vertex at R times its index; a coarse centre is the fine vertex (2y + 1,
    2x + 1) at R = 2 and the fine centre (Ry + o, Rx + o), o = (R - 1) / 2,
    at an odd R (ops/transfer.inject_plain, inject_general)."""
    ratios = [equal_ratio(c, f) for f, c in zip(grids, grids[1:])]
    g0 = grids[0]
    out = [None]
    for l in range(1, len(grids)):
        g = grids[l]
        vy, vx = np.divmod(np.arange((g.ny + 1) * (g.nx + 1)), g.nx + 1)
        cy, cx = np.divmod(np.arange(g.ny * g.nx), g.nx)
        y, x = np.concatenate([vy, cy]), np.concatenate([vx, cx])
        centre = np.arange(y.size) >= vy.size
        for R in reversed(ratios[:l]):
            o = 1 if R == 2 else (R - 1) // 2
            y = R * y + np.where(centre, o, 0)
            x = R * x + np.where(centre, o, 0)
            if R == 2:
                centre = np.zeros_like(centre)
        out.append(np.where(centre, (g0.ny + 1) * (g0.nx + 1) + y * g0.nx + x,
                            y * (g0.nx + 1) + x))
    return out


class NodeBuildPlan:
    """The multigrid build of a 2D hierarchy ``grids`` in one launch, fixed
    when it is built from the levels' kernel-N plans ``levels`` (one
    physics, one variant, the same constants)."""

    def __init__(self, grids, levels, *, device: torch.device | str):
        first = levels[0]
        for p in levels[1:]:
            if (p._symbol, p._variant, p.F) != (first._symbol, first._variant,
                                                first.F) or not np.array_equal(
                    p._head[-MAX_CONST:], first._head[-MAX_CONST:]):
                raise ValueError(f"{BUILD_NAME}: the levels' plans differ in "
                                 "physics, variant or constants")
        F, L = first.F, len(levels)
        self.grids, self.levels, self.F = list(grids), list(levels), F
        self.injs = [TransferPlan(grids[l + 1], grids[l], F, "inject")
                     for l in range(L - 1)]
        src = composed_index(grids)
        rec = np.zeros((L, len(RECORD)), np.int64)
        off = dict.fromkeys(RECORD[2:], 0)
        for l, p in enumerate(levels):
            n = p.nvert + p.ncell
            rec[l] = (p.nvert, p.ncell, off["first"], off["diag"],
                      -1 if p.mask is None else off["mask"],
                      -1 if l == 0 else off["src"], off["planes"],
                      -1 if l == 0 else off["states"])
            off["first"] += n
            off["diag"] += 3 * n
            off["mask"] += 0 if p.mask is None else F * p.nvert
            off["src"] += 0 if l == 0 else n
            off["planes"] += F * F * n
            off["states"] += 0 if l == 0 else 2 * F * n
        self.records = rec
        self.total, self._sizes = off["first"], (off["planes"], off["states"])
        self.table = torch.as_tensor(rec, device=device)
        self.diag = torch.cat([p.diag.reshape(-1) for p in levels])
        masks = [p.mask.reshape(-1) for p in levels if p.mask is not None]
        self.mask = torch.cat(masks) if masks else None
        self.src = (torch.as_tensor(np.concatenate(src[1:]).astype(np.int32),
                                    device=device) if L > 1 else None)
        self._head, self._variant = first._head, first._variant
        self._symbol = first._symbol.replace(NAME, BUILD_NAME)
        self._fn, self._dev = None, None

    def __call__(self, w, w0, dt):
        return (self.plain if w[0].is_cpu else self.kernel)(w, w0, dt)

    def _chained(self, w, w0, dt, plain):
        states, planes = [], []
        for l, p in enumerate(self.levels):
            states.append((w, w0))
            planes.append((p.plain if plain else p)(w, w0, dt))
            if l + 1 < len(self.levels):
                inj = self.injs[l].plain if plain else self.injs[l]
                w, w0 = inj(w), inj(w0)
        return states, planes

    def plain(self, w, w0, dt):
        """Each level's plain planes and the chained plain injections."""
        return self._chained(w, w0, dt, True)

    def sequence(self, w, w0, dt):
        """What the one launch replaces: a launch of N per level and the
        injections between them (kernel D, or slicing at an odd ratio)."""
        return self._chained(w, w0, dt, False)

    def check(self, w, w0) -> int:
        """The CUDA device index of the state pairs; raises unless they are
        contiguous float32 CUDA tensors of the finest level's shapes on the
        device of the plan's tensors."""
        dev = self.levels[0].check(w)
        if self.levels[0].check(w0) != dev:
            raise ValueError(f"{BUILD_NAME}: w and w0 on two devices")
        for t in (self.table, self.diag, self.mask, self.src):
            if t is not None and t.get_device() != dev:
                raise ValueError(f"{BUILD_NAME}: the plan's tensors are on "
                                 f"{t.device}, the state on cuda:{dev}")
        return dev

    def _bind(self, dev: int):
        lib = _lib.library()
        if self._head.size + 1 != lib.lib.pfh_jvp_param_floats():
            raise RuntimeError(f"{BUILD_NAME}: parameter block does not match "
                               "the kernel's JvpParams layout")
        self._fn, self._dev = getattr(lib.lib, self._symbol), dev
        return self._fn

    def views(self, w, w0, planes, states):
        """``(states, planes)`` per level from the two allocations at the
        records' offsets: the finest level's states are ``(w, w0)``."""
        F, out_s, out_p = self.F, [], []
        for l, (g, p) in enumerate(zip(self.grids, self.levels)):
            nv, nc = p.nvert, p.ncell
            o = int(self.records[l, RECORD.index("planes")])
            out_p.append((planes[o:o + F * F * nv].view(F, F, *g.vshape),
                          planes[o + F * F * nv:o + F * F * (nv + nc)].view(
                              F, F, *g.mshape)))
            if l == 0:
                out_s.append((w, w0))
                continue
            o = int(self.records[l, RECORD.index("states")])
            parts = []
            for k, (size, shape) in enumerate(((nv, g.vshape), (nc, g.mshape),
                                               (nv, g.vshape), (nc, g.mshape))):
                parts.append(states[o:o + F * size].view(F, *shape))
                o += F * size
            out_s.append((tuple(parts[:2]), tuple(parts[2:])))
        return out_s, out_p

    def kernel(self, w, w0, dt):
        dev = self.check(w, w0)
        fn = self._fn if dev == self._dev else self._bind(dev)
        params = np.append(self._head, np.float32(dt))
        planes = w[0].new_empty(self._sizes[0])
        states = w[0].new_empty(max(self._sizes[1], 1))
        err = fn(params.ctypes.data, *self._variant, self.table.data_ptr(),
                 len(self.levels), self.total, w[0].data_ptr(),
                 w[1].data_ptr(), w0[0].data_ptr(), w0[1].data_ptr(),
                 self.diag.data_ptr(),
                 None if self.mask is None else self.mask.data_ptr(),
                 None if self.src is None else self.src.data_ptr(),
                 planes.data_ptr(), states.data_ptr(), _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self._symbol}: CUDA error {err} at launch")
        _lib.count_launch(BUILD_NAME)
        return self.views(w, w0, planes, states)

    def info(self) -> dict:
        """Registers, spills and CTAs per SM of the one-launch form's
        instantiation."""
        return _lib.library().kernel_info(f"{self._symbol}_info",
                                          *self._variant)
