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

Face Dirichlet conditions (``DirichletBC3D``, bench6_3d's phi faces): the
residual's rows there are ``u - g``, the J.v's rows ``v``; ``bc_mask3d`` is
the 0/1 plane of those rows that the kernels read. Coordinate-dependent
forms (``needs_coords``, poisson3d) get the quadrature points' coordinates
in ``ctx.x``, ``ctx.y`` and ``ctx.z``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as tF

from pfhubbenchmarks_tpu_torch.fem.assembly import (QPContext, broadcast_term,
                                                    qpoint_tensors)
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


@dataclasses.dataclass(frozen=True)
class DirichletBC3D:
    """Strong BC on one boundary face of the vertex grid, one field.

    Counterpart of ``pfhubbenchmarks_tpu/fem/assembly3d.py:DirichletBC3D``
    (the reference's face-located dirichletbc, dolfinx/poisson3d.py:59-86).
    ``face`` is one of 'x0'/'x1'/'y0'/'y1'/'z0'/'z1' (the plane where that
    coordinate is 0 or L); ``g`` holds the nodal boundary values over the
    stored face shape (host numpy, padding entries 0), evaluated once at
    construction; ``index`` is the grid plane along the face normal.
    Residual rows become ``u - g``. The row updates are out of place, so
    ``torch.func`` can trace them."""

    field: int
    face: str      # 'x0' | 'x1' | 'y0' | 'y1' | 'z0' | 'z1'
    g: np.ndarray  # x faces: [Z, Y]; y faces: [Z, X]; z faces: [Y, X]
    index: int

    @staticmethod
    def make(grid: TetGrid, field: int, face: str, fn) -> "DirichletBC3D":
        """``fn(c1, c2)`` maps the two in-face coordinates to boundary data:
        x faces get (y, z), y faces (x, z), z faces (x, y)."""
        Z, Y, X = grid.vshape
        ax = face[0]
        if face not in ("x0", "x1", "y0", "y1", "z0", "z1"):
            raise ValueError(f"unknown face {face!r}")
        if ax == "x":
            c1 = np.arange(grid.ny + 1) * grid.hy
            c2 = np.arange(grid.nz + 1) * grid.hz
            stored, index = (Z, Y), 0 if face == "x0" else grid.nx
        elif ax == "y":
            c1 = np.arange(grid.nx + 1) * grid.hx
            c2 = np.arange(grid.nz + 1) * grid.hz
            stored, index = (Z, X), 0 if face == "y0" else grid.ny
        else:
            c1 = np.arange(grid.nx + 1) * grid.hx
            c2 = np.arange(grid.ny + 1) * grid.hy
            stored, index = (Y, X), 0 if face == "z0" else grid.nz
        C1, C2 = np.meshgrid(c1, c2, indexing="xy")  # [n2, n1]
        g = np.zeros(stored)
        g[: c2.size, : c1.size] = np.broadcast_to(
            np.asarray(fn(C1, C2), np.float64), C1.shape)
        return DirichletBC3D(field=field, face=face, g=g, index=index)

    @property
    def axis(self) -> int:
        """The axis of a field volume [Z, Y, X] that the index selects."""
        return {"x": 2, "y": 1, "z": 0}[self.face[0]]

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """The BC face of a vertex array [F, Z, Y, X]."""
        return v[self.field].select(self.axis, self.index)

    def put_rows(self, v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """A copy of ``v`` with its BC face replaced by ``rows``."""
        vol = torch.select_scatter(v[self.field], rows, self.axis, self.index)
        return torch.select_scatter(v, vol, 0, self.field)

    def apply_residual(self, rv, v, g=None):
        """Replace the BC rows with ``u - g`` (padding rows stay 0 - 0 = 0);
        ``g`` may be given as a tensor of ``rv``'s dtype and device."""
        if g is None:
            g = torch.as_tensor(self.g, dtype=rv.dtype, device=rv.device)
        return self.put_rows(rv, self.rows(v) - g)

    def apply_value(self, v):
        """Set the BC values into a state array (initial guesses)."""
        return self.put_rows(v, torch.as_tensor(self.g, dtype=v.dtype,
                                                device=v.device))


def bc_mask3d(grid: TetGrid, bcs, n_fields: int) -> np.ndarray | None:
    """0/1 float32 mask [F, Z, Y, X] of the Dirichlet vertex rows of the
    ``DirichletBC3D`` faces ``bcs``, or None without BCs: what kernels U and
    L read (ops/fem_jvp3d.py)."""
    if not bcs:
        return None
    m = np.zeros((n_fields,) + grid.vshape, np.float32)
    ext = (grid.nz + 1, grid.ny + 1, grid.nx + 1)
    for bc in bcs:
        sel = [slice(0, n) for n in ext]
        sel[bc.axis] = bc.index
        m[(bc.field, *sel)] = 1.0
    return m


def zero_bc_rows3d(w, bcs):
    """``(v,)`` with the rows of ``bcs`` set to 0, out of place: the
    multigrid cycle keeps restricted residuals and prolonged corrections out
    of the constraint rows (solve/gmg3d.py)."""
    (v,) = w
    for bc in bcs:
        v = bc.put_rows(v, torch.zeros_like(bc.rows(v)))
    return (v,)


def _eval_qp(T: TabTensors3D, loc):
    """loc [8, F, nz, ny, nx] -> per-field tuples of values [6, nq, ...]
    and gradients (3 x [6, 1, ...])."""
    uq = torch.einsum("tqs,sfzyx->ftqzyx", T.Bq, loc)
    du = torch.einsum("tsd,sfzyx->fdtzyx", T.Gs, loc)[:, :, :, None]
    n = uq.shape[0]
    return (tuple(uq[i] for i in range(n)),
            tuple((du[i, 0], du[i, 1], du[i, 2]) for i in range(n)))


def _context(T: TabTensors3D, grid: TetGrid, w, w0, dt,
             coords=None) -> QPContext:
    """``coords``: the ``qpoint_tensors`` of a coordinate-dependent form."""
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    u_t, du_t = _eval_qp(T, local_values3d(w, nz, ny, nx))
    if w0 is None:
        return QPContext(u=u_t, du=du_t, u0=None, du0=None, dt=dt,
                         **(coords or {}))
    u0_t, du0_t = _eval_qp(T, local_values3d(w0, nz, ny, nx))
    return QPContext(u=u_t, du=du_t, u0=u0_t, du0=du0_t, dt=dt,
                     **(coords or {}))


def _assemble(T: TabTensors3D, grid: TetGrid, source_flux):
    """sum over quadrature points of w (s lambda + f . grad lambda),
    scattered to ``(rv,)``."""
    source, flux = source_flux
    full_shape = (6, T.Bq.shape[1], grid.nz, grid.ny, grid.nx)
    src = torch.stack([broadcast_term(s, full_shape, T.WB) for s in source])
    r_loc = torch.einsum("tqs,ftqzyx->sfzyx", T.WB, src)
    for d in range(3):
        fd = torch.stack([broadcast_term(f[d], full_shape, T.WB)
                          for f in flux])
        r_loc = r_loc + torch.einsum("tqs,ftqzyx->sfzyx", T.WG[d], fd)
    return scatter_add3d(r_loc, grid.vshape, grid.nz, grid.ny, grid.nx)


def make_residual3d(grid: TetGrid, terms: Callable, n_fields: int, *,
                    device: torch.device | str, dirichlet=(),
                    needs_coords: bool = False, dtype=torch.float64):
    """Build ``residual(w, w0, dt) -> (rv,)`` for a system's weak form.
    The rows of each ``DirichletBC3D`` in ``dirichlet`` become ``u - g``;
    ``needs_coords`` puts the quadrature points' coordinates into ``ctx.x``,
    ``ctx.y`` and ``ctx.z``."""
    del n_fields  # the field count follows from the state
    T = TabTensors3D.make(grid, dtype, device)
    coords = qpoint_tensors(grid, dtype, device) if needs_coords else {}
    bc_g = [torch.as_tensor(bc.g, dtype=dtype, device=device)
            for bc in dirichlet]

    def residual(w, w0, dt):
        (rv,) = _assemble(T, grid, terms(_context(T, grid, w, w0, dt,
                                                  coords=coords)))
        for bc, g in zip(dirichlet, bc_g):
            rv = bc.apply_residual(rv, w[0], g)
        return (rv,)

    return residual


def make_tangent_jvp3d(grid: TetGrid, tangent, *, device: torch.device | str,
                       dirichlet=(), dtype=torch.float64):
    """Build ``jv(w, w0, dt, v) -> (rv,)``, the J.v of ``make_residual3d``
    assembled from a hand-written pointwise ``tangent(ctx, tctx) ->
    (source, flux)`` (``tctx`` holds v and its gradients at the quadrature
    points): the function ``torch.func.jvp`` of the residual computes,
    without forward AD. The rows of each ``DirichletBC3D`` are identity rows
    (the tangent of ``u - g``)."""
    T = TabTensors3D.make(grid, dtype, device)

    def jv(w, w0, dt, v):
        (rv,) = _assemble(T, grid, tangent(_context(T, grid, w, w0, dt),
                                           _context(T, grid, v, None, None)))
        for bc in dirichlet:
            rv = bc.put_rows(rv, bc.rows(v[0]))
        return (rv,)

    return jv


def make_functional3d(grid: TetGrid, density: Callable, *,
                      device: torch.device | str, needs_coords: bool = False,
                      dtype=torch.float64):
    """Build ``value(w) -> scalar tensor`` for an integral functional;
    ``needs_coords`` as in ``make_residual3d``."""
    T = TabTensors3D.make(grid, dtype, device)
    coords = qpoint_tensors(grid, dtype, device) if needs_coords else {}
    full_shape = (6, T.Bq.shape[1], grid.nz, grid.ny, grid.nx)

    def value(w):
        ctx = _context(T, grid, w, None, None, coords=coords)
        e = torch.broadcast_to(density(ctx), full_shape)
        return torch.einsum("tq,tqzyx->", T.wq, e)

    return value
