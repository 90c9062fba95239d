"""Kernel W (``csrc/fem_tri_box.cuh``; ``csrc/ch_box.cu`` at BM1's physics,
``csrc/chac_box.cu`` at BM2's coupled physics, ``csrc/ach_box.cu`` at
BM3's, ``csrc/acha_box.cu`` at the anisotropic BM3's, ``csrc/chp_box.cu``
at BM6's with its Dirichlet rows): the crossed-P1 J.v over shared-memory
triangle boxes, each triangle's quadrature-point tangent evaluated once,
every node summed in the gather's order.

It is the ``form="box"`` of ops/ch_jvp.make_ch_jvp, ops/chac_jvp.make_chac_jvp
and ops/ach_jvp.make_ach_jvp: the outer Krylov J.v and the exported A z of
bench1, bench2, bench2_eta1 and bench3 (``BenchmarkProblem.outer_jvp_form``),
in place of kernels A, F and G there, and at BM6's physics (``form="box"``
of ops/chp_jvp.make_chp_jvp) bench6's outer J.v in place of kernel E; like
them it replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:
make_pallas_jvp``. A, E, F and G stay on every multigrid level (inside
kernel L and the chains).

A CTA owns a box of ``TRI_BOX[kind]`` = (rows, columns) vertices and the
centres of the cells with the same indices (``box_ranges``), one CTA per box
(``tri_boxes``). The residual box (ops/residual_box.py) plans its boxes with
the same geometry (``grid_boxes``, ``grid_box_ranges``). ``TriBoxPlan``
fixes, once per grid, the box grid, the launcher and the parameter block
(the gather J.v's tabulation and constants; each call writes dt into its
last float). W takes the 4-point rule and the coupled operator, and
Dirichlet rows only at the physics of ``MASKED`` (BM6's: on a masked row
the tangent value itself, then ``b`` less it, as the gather's store); a
plan refuses anything else when it is made.

``make_box_jvp(gather)`` returns ``jv(w, w0, dt, v, b=None)`` over the
gather J.v ``gather`` (ops/fem_jvp.make_fem_jvp): ``jv.plain`` is the
gather's plain version (the benchmark's hand-written tangent assembled in
f32), taken for CPU tensors only; a CUDA tensor launches W, and nothing
falls back. ``jv.gather`` is the gather J.v, W's comparison. W counts its
launches as ``tri_box``, at the anisotropic BM3 as ``tri_box_acha`` and at
BM6 as ``tri_box_chp``.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import GatherLaunch

NAME = "tri_box"
# Kernel W's box per physics: owned vertex rows and columns (csrc/ch_box.cu
# ChBox, csrc/chac_box.cu ChacBox, csrc/ach_box.cu AchBox, csrc/acha_box.cu
# AchaBox, csrc/chp_box.cu ChpBox; tests/test_torch_tri_box.py and
# tests/test_torch_bench3_aniso.py hold them equal)
TRI_BOX = {"ch": (7, 7), "chac": (7, 7), "ach": (7, 15), "acha": (7, 15),
           "chp": (7, 7)}
# the physics whose instantiation takes a Dirichlet vertex mask (kMask; the
# other launchers refuse a mask too)
MASKED = ("chp",)
RULE_POINTS = 4


def grid_boxes(shape: tuple[int, int], ny: int, nx: int) -> tuple[int, int]:
    """The boxes of ``shape`` = (BY, BX) owned vertices along (y, x) of a
    grid of ny x nx cells: ceil((n + 1) / B), one CTA each, x fastest."""
    by, bx = shape
    return (ny + by) // by, (nx + bx) // bx


def grid_box_ranges(shape: tuple[int, int], ny: int, nx: int,
                    box: tuple[int, int]):
    """Box ``box`` = (iy, ix) of ``shape``: per axis (y, x) the vertices it
    owns, the centres it owns (the cells with the same indices) and the
    cells it evaluates (one halo cell below and to the left of the owned
    ones), clipped to the grid."""
    out = []
    for n, b, i in zip((ny, nx), shape, box):
        o = i * b
        out.append((range(o, min(o + b, n + 1)), range(o, min(o + b, n)),
                    range(max(o - 1, 0), min(o + b, n))))
    return tuple(out)


def tri_boxes(kind: str, ny: int, nx: int) -> tuple[int, int]:
    """W's boxes along (y, x) at the physics ``kind``."""
    return grid_boxes(TRI_BOX[kind], ny, nx)


def box_ranges(kind: str, ny: int, nx: int, box: tuple[int, int]):
    """``grid_box_ranges`` of W's box at the physics ``kind``."""
    return grid_box_ranges(TRI_BOX[kind], ny, nx, box)


class TriBoxPlan:
    """Kernel W's launch on one grid, fixed when it is built, from the
    gather J.v's launch record (ops/fem_jvp.GatherLaunch)."""

    def __init__(self, launch: GatherLaunch):
        if launch.kind not in TRI_BOX:
            raise NotImplementedError(f"{NAME}: no instantiation for the "
                                      f"physics {launch.kind!r}")
        if launch.nq != RULE_POINTS:
            raise NotImplementedError(f"{NAME}: built for {RULE_POINTS}-point "
                                      f"rules, the grid's has {launch.nq}")
        if launch.mask is not None and launch.kind not in MASKED:
            raise NotImplementedError(f"{NAME}: takes no Dirichlet rows at "
                                      f"the physics {launch.kind!r}")
        variant = launch.variant
        if launch.kind == "chac":
            if variant[1]:
                raise NotImplementedError(f"{NAME}: the coupled operator only")
            variant = variant[:1]
        self.box = TRI_BOX[launch.kind]
        self.dims = launch.dims
        self.boxes = tri_boxes(launch.kind, *launch.dims)
        self.variant = variant
        self.symbol = f"pfh_{launch.kind}_box"
        self.mask = launch.mask
        self.name = _lib.counter(NAME, launch.kind)
        F = launch.n_fields
        ny, nx = launch.dims
        self.shapes = ((F, ny + 1, nx + 1), (F, ny, nx))
        self.params = np.append(launch.head, np.float32(0.0))
        self._fn = None

    def _bind(self):
        """The C launcher, resolved once, and the parameter layout checked
        once."""
        lib = _lib.library()
        if self.params.size != lib.lib.pfh_jvp_param_floats():
            raise RuntimeError(f"{NAME}: parameter block does not match the "
                               "kernel's JvpParams layout")
        self._fn = getattr(lib.lib, self.symbol)
        return self._fn

    def __call__(self, w, v, dt, b=None):
        """``J(w, dt) v``, or ``b - J v``, by one launch of W."""
        ts = [*w, *v] + ([*b] if b is not None else [])
        _lib.check_cuda(self.name, ts + ([self.mask] if self.mask is not None
                                         else []))
        for pair in (w, v) if b is None else (w, v, b):
            _lib.check_shapes(self.name, pair, *self.shapes)
        fn = self._fn or self._bind()
        out = (torch.empty_like(v[0]), torch.empty_like(v[1]))
        self.params[-1] = dt
        bv, bm = (None, None) if b is None else (b[0].data_ptr(),
                                                 b[1].data_ptr())
        mask = None if self.mask is None else self.mask.data_ptr()
        err = fn(self.params.ctypes.data, RULE_POINTS, *self.variant,
                 *self.box, w[0].data_ptr(), w[1].data_ptr(), v[0].data_ptr(),
                 v[1].data_ptr(), bv, bm, mask, out[0].data_ptr(),
                 out[1].data_ptr(), *self.dims, _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        _lib.count_launch(self.name)
        return out

    def info(self) -> dict:
        """Registers, spills, shared bytes and CTAs per SM of this plan's
        instantiation (``_lib.KernelLibrary.kernel_info``)."""
        return _lib.library().kernel_info(f"{self.symbol}_info", *self.variant)


def make_box_jvp(gather):
    """W over the gather J.v ``gather``: ``jv(w, w0, dt, v, b=None)``, with
    ``jv.plain`` the gather's plain version, ``jv.kernel`` W, ``jv.gather``
    the gather J.v and ``jv.plan`` W's ``TriBoxPlan``."""
    plan = TriBoxPlan(gather.launch)

    def kernel(w, w0, dt, v, b=None):
        del w0  # the tangents do not read the previous time level
        return plan(w, v, dt, b)

    def jv(w, w0, dt, v, b=None):
        return (gather.plain if _lib.on_cpu(v[0]) else kernel)(w, w0, dt, v, b)

    jv.plain = gather.plain
    jv.kernel = kernel
    jv.gather = gather
    jv.plan = plan
    jv.n_fields = gather.n_fields
    return jv
