"""Kernel R (``csrc/fem_residual.cuh``): the f32 residual of a benchmark's
weak form, the one the cp line search and its noise floor read
(solve/newton.py) when ``fast_linesearch`` is on.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_residual``.
``make_fem_residual`` returns ``res(w, w0, dt)``: ``R(w, w0, dt)`` as an f32
pair, with the Dirichlet rows ``u - g``. The physics is the benchmark's
``terms``, mirrored in CUDA by ``Phys::residual`` (csrc/phys_*.cuh); the
tabulation, the constants and ``dt`` are launch arguments, as for the J.v
kernels (ops/fem_jvp.py).

The plain version beside it is the residual's einsum assembly in f32
(fem/assembly.make_residual, the port's f32 residual before kernel R), which
the wrapper takes for CPU tensors only; a CUDA tensor launches the kernel.
``res.launch`` (``ResidualLaunch``) is what R's launcher receives besides
its operands and dt; the residual box (ops/residual_box.py) is planned from
it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask, make_residual
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import params_head, with_dt

NAME = "residual"


@dataclasses.dataclass(frozen=True)
class ResidualLaunch:
    """What kernel R's launcher receives besides its operands and dt:
    ``kind`` the physics ("ch", "chp", "chac"), ``head`` the parameter block
    without dt, ``nq`` the rule's point count, ``variant`` the int arguments
    after it (BM2's field count), ``mask`` and ``g`` the Dirichlet planes
    (``dirichlet_planes``, on the device) or None, ``dims`` the grid's cells
    (ny, nx), ``n_fields`` F."""

    kind: str
    head: np.ndarray
    nq: int
    variant: tuple[int, ...]
    mask: torch.Tensor | None
    g: torch.Tensor | None
    dims: tuple[int, int]
    n_fields: int


def dirichlet_planes(grid: CrossedTriGrid, dirichlet, n_fields: int):
    """``(mask, g)``: the 0/1 vertex mask of the Dirichlet rows and the plane
    of their values g (0 elsewhere), float32 [F, Yv, Xv], or ``(None,
    None)`` without rows. Later conditions overwrite earlier ones, as
    ``DirichletBC.apply_residual`` applied in order does."""
    mask = bc_mask(grid, dirichlet, n_fields)
    if mask is None:
        return None, None
    g = np.zeros_like(mask)
    for bc in dirichlet:
        if bc.side in ("left", "right"):
            g[bc.field, :, bc.index] = bc.g
        else:
            g[bc.field, bc.index, :] = bc.g
    return mask, g


def make_fem_residual(grid: CrossedTriGrid, terms, n_fields: int, *,
                      symbol: str, constants: tuple[float, ...],
                      device: torch.device | str, dirichlet=(), variant=()):
    """``terms`` is the benchmark's pointwise weak form (the plain version
    assembles it), ``symbol`` the C launcher, ``constants`` the physics
    constants in the kernel's order, ``variant`` the launcher's int
    arguments after the point count (BM2's field count). ``res.plain`` and
    ``res.kernel`` are the two versions, ``res.launch`` the launch record
    (``ResidualLaunch``)."""
    if grid.periodic or grid.pad_to != (1, 1):
        raise NotImplementedError(f"{NAME} takes unpadded, non-periodic grids")
    plain = make_residual(grid, terms, n_fields, device=device,
                          dirichlet=dirichlet, dtype=torch.float32)
    head = params_head(grid, constants, NAME)
    nq = grid.tab().nq
    vshape, mshape = (n_fields,) + grid.vshape, (n_fields,) + grid.mshape
    mask, g = (None if a is None else torch.as_tensor(a, device=device)
               for a in dirichlet_planes(grid, dirichlet, n_fields))

    def kernel(w, w0, dt):
        _lib.check_cuda(NAME, [*w, *w0] + ([mask, g] if mask is not None else []))
        for pair in (w, w0):
            _lib.check_shapes(NAME, pair, vshape, mshape)
        out = (torch.empty_like(w[0]), torch.empty_like(w[1]))
        params = with_dt(head, dt, NAME)
        _lib.library().call(
            symbol, params.ctypes.data, nq, *variant, w[0].data_ptr(),
            w[1].data_ptr(), w0[0].data_ptr(), w0[1].data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if g is None else g.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), grid.ny, grid.nx, _lib.stream_handle())
        _lib.count_launch(NAME)
        return out

    def res(w, w0, dt):
        return (plain if _lib.on_cpu(w[0]) else kernel)(w, w0, dt)

    res.plain = plain
    res.kernel = kernel
    res.launch = ResidualLaunch(
        kind=symbol.removeprefix("pfh_").removesuffix("_residual"), head=head,
        nq=nq, variant=tuple(variant), mask=mask, g=g, dims=(grid.ny, grid.nx),
        n_fields=n_fields)
    return res
