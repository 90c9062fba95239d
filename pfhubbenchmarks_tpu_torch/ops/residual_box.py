"""The residual box (``csrc/fem_tri_box.cuh`` ``residual_box_kernel``;
``csrc/chac_rbox.cu`` at BM2's physics, ``csrc/chp_rbox.cu`` at BM6's with
its Dirichlet rows): kernel R's f32 residual over shared-memory triangle
boxes, each triangle's point residuals evaluated once, every node summed in
R's order, so it gives R's bits.

It is the ``form="box"`` of the benchmarks' ``kernel_residual``: the f32
residual of the cp line search and its noise floor (solve/newton.py) of
bench2, bench2_eta1 and bench6 (``BenchmarkProblem.residual_form``), in
place of kernel R there; like R it replaces
``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual``.

``ResidualBoxPlan`` fixes, once per grid, from R's launch record
(ops/fem_residual.ResidualLaunch): the box grid (``RESIDUAL_BOX[kind]``
owned vertex rows and columns, the geometry of ops/tri_box.grid_boxes), the
launcher, the parameter block (each call writes dt into its last float) and
the Dirichlet planes. It takes the 4-point rule and refuses a physics with
no instantiation when it is made.

``make_box_residual(gather)`` returns ``res(w, w0, dt)`` over R's wrapper
``gather`` (ops/fem_residual.make_fem_residual): ``res.plain`` is R's plain
version (the f32 einsum assembly), taken for CPU tensors only; a CUDA
tensor launches the residual box, and nothing falls back. ``res.gather`` is
R, its comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_residual import ResidualLaunch
from pfhubbenchmarks_tpu_torch.ops.tri_box import grid_boxes

NAME = "residual_box"
# the residual box per physics: owned vertex rows and columns
# (csrc/chac_rbox.cu ChacRBox, csrc/chp_rbox.cu ChpRBox;
# tests/test_torch_residual_box.py holds them equal)
RESIDUAL_BOX = {"chac": (7, 7), "chp": (7, 7)}
RULE_POINTS = 4


class ResidualBoxPlan:
    """The residual box's launch on one grid, fixed when it is built, from
    R's launch record."""

    def __init__(self, launch: ResidualLaunch):
        if launch.kind not in RESIDUAL_BOX:
            raise NotImplementedError(f"{NAME}: no instantiation for the "
                                      f"physics {launch.kind!r}")
        if launch.nq != RULE_POINTS:
            raise NotImplementedError(f"{NAME}: built for {RULE_POINTS}-point "
                                      f"rules, the grid's has {launch.nq}")
        self.box = RESIDUAL_BOX[launch.kind]
        self.dims = launch.dims
        self.boxes = grid_boxes(self.box, *launch.dims)
        self.variant = launch.variant
        self.symbol = f"pfh_{launch.kind}_rbox"
        F = launch.n_fields
        ny, nx = launch.dims
        self.shapes = ((F, ny + 1, nx + 1), (F, ny, nx))
        self.planes = (launch.mask, launch.g)
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

    def __call__(self, w, w0, dt):
        """``R(w, w0, dt)`` by one launch of the residual box."""
        mask, g = self.planes
        _lib.check_cuda(NAME, [*w, *w0] + ([mask, g] if mask is not None
                                            else []))
        for pair in (w, w0):
            _lib.check_shapes(NAME, pair, *self.shapes)
        fn = self._fn or self._bind()
        out = (torch.empty_like(w[0]), torch.empty_like(w[1]))
        self.params[-1] = dt
        err = fn(self.params.ctypes.data, RULE_POINTS, *self.variant,
                 *self.box, w[0].data_ptr(), w[1].data_ptr(), w0[0].data_ptr(),
                 w0[1].data_ptr(), None if mask is None else mask.data_ptr(),
                 None if g is None else g.data_ptr(), out[0].data_ptr(),
                 out[1].data_ptr(), *self.dims, _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        _lib.count_launch(NAME)
        return out

    def info(self) -> dict:
        """Registers, spills, shared bytes and CTAs per SM of this plan's
        instantiation (``_lib.KernelLibrary.kernel_info``)."""
        return _lib.library().kernel_info(f"{self.symbol}_info", *self.variant)


def make_box_residual(gather):
    """The residual box over R's wrapper ``gather``: ``res(w, w0, dt)``,
    with ``res.plain`` R's plain version, ``res.kernel`` the residual box,
    ``res.gather`` R and ``res.plan`` the ``ResidualBoxPlan``."""
    plan = ResidualBoxPlan(gather.launch)

    def res(w, w0, dt):
        return (gather.plain if _lib.on_cpu(w[0]) else plan)(w, w0, dt)

    res.plain = gather.plain
    res.kernel = plan
    res.gather = gather
    res.plan = plan
    return res
