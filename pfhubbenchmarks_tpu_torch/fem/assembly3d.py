"""Matrix-free structured P1 assembly in 3D (Kuhn tets), as dense tensor ops.

Counterpart of ``pfhubbenchmarks_tpu/fem/assembly3d.py``; the same design as
the 2D assembly (fem/assembly.py): gather the 8 corner slices of every hex
cell, evaluate the physics at the tets' quadrature points by einsums, and
scatter back with shifted pads. The ``terms`` interface is the 2D one
(``ctx.du[i]`` is a 3-tuple), so the weak-form builders of models/forms.py
serve unchanged.

State: ``w = (v,)`` with v ``[F, Z, Y, X]`` (fem/grid3d.py).

``make_tangent_jvp3d`` assembles a hand-written pointwise tangent the same
way: the plain version of the 3D J.v kernel (ops/fem_jvp3d.py).

Face Dirichlet conditions (``DirichletBC3D``) and coordinate-dependent terms
are not yet ported: the residual factories raise for them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as tF

from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid, _SLOT_XYZ


def local_values3d(w, nz: int, ny: int, nx: int):
    """(v,) -> [8, F, nz, ny, nx], the corner slots of every cell."""
    (v,) = w
    return torch.stack([v[:, dz: nz + dz, dy: ny + dy, dx: nx + dx]
                        for (dx, dy, dz) in _SLOT_XYZ])


def scatter_add3d(r_loc, vshape, nz: int, ny: int, nx: int):
    """[8, F, nz, ny, nx] -> (rv,) padded to vshape, slots added in order."""
    Z, Y, X = vshape
    out = None
    for s, (dx, dy, dz) in enumerate(_SLOT_XYZ):
        # F.pad orders pads from the last dim: (x_lo, x_hi, y_lo, y_hi, z_lo, z_hi)
        p = tF.pad(r_loc[s], (dx, X - nx - dx, dy, Y - ny - dy, dz, Z - nz - dz))
        out = p if out is None else out + p
    return (out,)


@dataclasses.dataclass(frozen=True)
class TabTensors3D:
    """A grid's tabulation as tensors of one dtype on one device, with the
    weight-premultiplied forms the residual contracts against."""

    Bq: torch.Tensor   # [6, nq, 8]
    Gs: torch.Tensor   # [6, 8, 3]
    wq: torch.Tensor   # [6, nq]
    WB: torch.Tensor   # [6, nq, 8]
    WG: tuple          # 3 x [6, nq, 8]

    @staticmethod
    def make(grid: TetGrid, dtype, device) -> "TabTensors3D":
        tab = grid.tab()

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return TabTensors3D(
            Bq=t(tab.Bq), Gs=t(tab.Gs), wq=t(tab.wq),
            WB=t(tab.wq[:, :, None] * tab.Bq),
            WG=tuple(t(tab.wq[:, :, None] * tab.Gs[:, None, :, d])
                     for d in range(3)))


def _check(dirichlet=(), needs_coords: bool = False):
    if dirichlet:
        raise NotImplementedError(
            "3D Dirichlet faces (DirichletBC3D) are not yet ported to the "
            "PyTorch package")
    if needs_coords:
        raise NotImplementedError(
            "coordinate-dependent terms are not yet ported to the PyTorch "
            "package")


def _eval_qp(T: TabTensors3D, loc):
    """loc [8, F, nz, ny, nx] -> per-field tuples of values [6, nq, ...]
    and gradients (3 x [6, 1, ...])."""
    uq = torch.einsum("tqs,sfzyx->ftqzyx", T.Bq, loc)
    du = torch.einsum("tsd,sfzyx->fdtzyx", T.Gs, loc)[:, :, :, None]
    n = uq.shape[0]
    return (tuple(uq[i] for i in range(n)),
            tuple((du[i, 0], du[i, 1], du[i, 2]) for i in range(n)))


def _context(T: TabTensors3D, grid: TetGrid, w, w0, dt) -> QPContext:
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    u_t, du_t = _eval_qp(T, local_values3d(w, nz, ny, nx))
    if w0 is None:
        return QPContext(u=u_t, du=du_t, u0=None, du0=None, dt=dt)
    u0_t, du0_t = _eval_qp(T, local_values3d(w0, nz, ny, nx))
    return QPContext(u=u_t, du=du_t, u0=u0_t, du0=du0_t, dt=dt)


def _assemble(T: TabTensors3D, grid: TetGrid, source_flux):
    """sum over quadrature points of w (s lambda + f . grad lambda),
    scattered to ``(rv,)``."""
    source, flux = source_flux
    full_shape = (6, T.Bq.shape[1], grid.nz, grid.ny, grid.nx)
    src = torch.stack([torch.broadcast_to(s, full_shape) for s in source])
    r_loc = torch.einsum("tqs,ftqzyx->sfzyx", T.WB, src)
    for d in range(3):
        fd = torch.stack([torch.broadcast_to(f[d], full_shape) for f in flux])
        r_loc = r_loc + torch.einsum("tqs,ftqzyx->sfzyx", T.WG[d], fd)
    return scatter_add3d(r_loc, grid.vshape, grid.nz, grid.ny, grid.nx)


def make_residual3d(grid: TetGrid, terms: Callable, n_fields: int, *,
                    device: torch.device | str, dirichlet=(),
                    needs_coords: bool = False, dtype=torch.float64):
    """Build ``residual(w, w0, dt) -> (rv,)`` for a system's weak form."""
    del n_fields  # the field count follows from the state
    _check(dirichlet, needs_coords)
    T = TabTensors3D.make(grid, dtype, device)

    def residual(w, w0, dt):
        return _assemble(T, grid, terms(_context(T, grid, w, w0, dt)))

    return residual


def make_tangent_jvp3d(grid: TetGrid, tangent, *, device: torch.device | str,
                       dtype=torch.float64):
    """Build ``jv(w, w0, dt, v) -> (rv,)``, the J.v of ``make_residual3d``
    assembled from a hand-written pointwise ``tangent(ctx, tctx) ->
    (source, flux)`` (``tctx`` holds v and its gradients at the quadrature
    points): the function ``torch.func.jvp`` of the residual computes,
    without forward AD."""
    T = TabTensors3D.make(grid, dtype, device)

    def jv(w, w0, dt, v):
        return _assemble(T, grid, tangent(_context(T, grid, w, w0, dt),
                                          _context(T, grid, v, None, None)))

    return jv


def make_functional3d(grid: TetGrid, density: Callable, *,
                      device: torch.device | str, needs_coords: bool = False,
                      dtype=torch.float64):
    """Build ``value(w) -> scalar tensor`` for an integral functional."""
    _check((), needs_coords)
    T = TabTensors3D.make(grid, dtype, device)
    full_shape = (6, T.Bq.shape[1], grid.nz, grid.ny, grid.nx)

    def value(w):
        ctx = _context(T, grid, w, None, None)
        e = torch.broadcast_to(density(ctx), full_shape)
        return torch.einsum("tq,tqzyx->", T.wq, e)

    return value
