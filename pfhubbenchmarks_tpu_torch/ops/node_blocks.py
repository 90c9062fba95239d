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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
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
