"""Matrix-free structured P1 assembly as dense tensor ops.

Counterpart of ``pfhubbenchmarks_tpu/fem/assembly.py``. The weak-form
residual

    r_k = sum_cells sum_tris sum_q  w * ( s(u) * lambda_k + f(u, grad u) . grad lambda_k )

is evaluated as a few small einsums over per-cell slot arrays gathered by
slicing, followed by shifted adds (the scatter).

State pair: ``w = (v, m)`` with v ``[F, ny+1, nx+1]`` (vertices) and
m ``[F, ny, nx]`` (cell centres), in the JAX package's padded layout.

Model interface: a system provides pointwise physics
``terms(ctx) -> (source, flux)`` over a ``QPContext``; Jacobian-vector
products come from ``torch.func.jvp`` of the assembled residual (the plain
versions) or from the hand-written tangent in the CUDA kernels (ops/).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as tF

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid


# ---------------------------------------------------------------------------
# gather / scatter between grids and per-cell slot arrays
# ---------------------------------------------------------------------------

def local_values(w, ny: int, nx: int):
    """Gather cell-local slot values: (v, m) -> [5, F, ny, nx]."""
    v, m = w
    return torch.stack([
        v[:, :ny, :nx],
        v[:, :ny, 1: nx + 1],
        v[:, 1: ny + 1, 1: nx + 1],
        v[:, 1: ny + 1, :nx],
        m[:, :ny, :nx],
    ])


def scatter_add(r_loc, vshape, mshape, ny: int, nx: int):
    """Scatter per-cell slot contributions back: [5, F, ny, nx] -> (rv, rm).

    Pad-and-add, as in the JAX package; the padding of the stored shapes
    stays exactly zero."""
    ey, ex = vshape[0] - (ny + 1), vshape[1] - (nx + 1)
    # F.pad orders pads from the last dim: (x_lo, x_hi, y_lo, y_hi)
    rv = (tF.pad(r_loc[0], (0, 1 + ex, 0, 1 + ey))
          + tF.pad(r_loc[1], (1, ex, 0, 1 + ey))
          + tF.pad(r_loc[2], (1, ex, 1, ey))
          + tF.pad(r_loc[3], (0, 1 + ex, 1, ey)))
    rm = tF.pad(r_loc[4], (0, mshape[1] - nx, 0, mshape[0] - ny))
    return rv, rm


# ---------------------------------------------------------------------------
# pointwise evaluation context handed to model physics
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QPContext:
    """Field data at quadrature points, per field as tuples (UFL-like access)."""

    u: tuple          # field i -> [4, nq, ny, nx]
    du: tuple         # field i -> (ddx, ddy), each [4, 1, ny, nx]
    u0: tuple | None
    du0: tuple | None
    dt: torch.Tensor | float | None
    # global coordinates of the quadrature points, for coordinate-dependent
    # forms (``needs_coords``): [4, nq, ny, nx] (3D: [6, nq, nz, ny, nx])
    x: torch.Tensor | None = None
    y: torch.Tensor | None = None
    z: torch.Tensor | None = None   # 3D only


def _eval_qp(Bq, Gs, loc, centred=False):
    """loc [5, F, ny, nx] -> (u_q [F, 4, nq, ny, nx], du [F, 2, 4, 1, ny, nx]).
    ``centred``: the gradients from the slots' differences to the centre
    (slot 4, in every triangle), as the kernels form the state's gradient
    (csrc/fem_params.cuh ``state_grad``): the same function, since a
    triangle's basis gradients sum to zero, without the cancellation of
    slot values near each other."""
    uq = torch.einsum("tqs,sfyx->ftqyx", Bq, loc)
    if centred:
        du = torch.einsum("tsd,sfyx->fdtyx", Gs[:, :4], loc[:4] - loc[4:5])
    else:
        du = torch.einsum("tsd,sfyx->fdtyx", Gs, loc)
    return uq, du[:, :, :, None]


def _as_tuples(uq, du):
    n_fields = uq.shape[0]
    u_t = tuple(uq[i] for i in range(n_fields))
    du_t = tuple((du[i, 0], du[i, 1]) for i in range(n_fields))
    return u_t, du_t


@dataclasses.dataclass(frozen=True)
class TabTensors:
    """A grid's tabulation as tensors of one dtype on one device, with the
    weight-premultiplied forms the residual contracts against."""

    Bq: torch.Tensor
    Gs: torch.Tensor
    wq: torch.Tensor
    WB: torch.Tensor
    WGx: torch.Tensor
    WGy: torch.Tensor

    @staticmethod
    def make(grid: CrossedTriGrid, dtype, device) -> "TabTensors":
        tab = grid.tab()

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return TabTensors(
            Bq=t(tab.Bq), Gs=t(tab.Gs), wq=t(tab.wq),
            WB=t(tab.wq[:, :, None] * tab.Bq),
            WGx=t(tab.wq[:, :, None] * tab.Gs[:, None, :, 0]),
            WGy=t(tab.wq[:, :, None] * tab.Gs[:, None, :, 1]))


# ---------------------------------------------------------------------------
# residual / functional factories
# ---------------------------------------------------------------------------

def _check_grid(grid: CrossedTriGrid):
    if grid.periodic:
        raise NotImplementedError(
            "periodic grids are not yet ported to the PyTorch package")


def make_residual(
    grid: CrossedTriGrid,
    terms: Callable[[QPContext], tuple[Sequence, Sequence]],
    n_fields: int,
    *,
    device: torch.device | str,
    dirichlet=(),
    needs_coords: bool = False,
    dtype=torch.float64,
):
    """Build ``residual(w, w0, dt) -> (rv, rm)`` for a system's weak form.
    The rows of each ``DirichletBC`` in ``dirichlet`` become ``u - g``;
    ``needs_coords`` puts the quadrature points' coordinates into ``ctx.x``
    and ``ctx.y``."""
    del n_fields  # the field count follows from the state
    _check_grid(grid)
    T = TabTensors.make(grid, dtype, device)
    coords = qpoint_tensors(grid, dtype, device) if needs_coords else {}
    bc_g = [torch.as_tensor(bc.g, dtype=dtype, device=device) for bc in dirichlet]

    def residual(w, w0, dt):
        rv, rm = _assemble(T, grid, terms(_context(T, grid, w, w0, dt,
                                                   coords=coords)))
        for bc, g in zip(dirichlet, bc_g):
            rv = bc.apply_residual(rv, w[0], g)
        return rv, rm

    return residual


def qpoint_tensors(grid, dtype, device) -> dict:
    """``grid.qpoint_coords()`` as the tensors ``x``, ``y`` (3D also ``z``)
    of ``QPContext``, keyed by their field names."""
    return {k: torch.as_tensor(a, dtype=dtype, device=device)
            for k, a in zip("xyz", grid.qpoint_coords())}


def _context(T: "TabTensors", grid: CrossedTriGrid, w, w0, dt,
             centred=False, coords=None) -> QPContext:
    """``coords``: the ``qpoint_tensors`` of a coordinate-dependent form."""
    uq, du = _eval_qp(T.Bq, T.Gs, local_values(w, grid.ny, grid.nx), centred)
    u_t, du_t = _as_tuples(uq, du)
    if w0 is None:
        return QPContext(u=u_t, du=du_t, u0=None, du0=None, dt=dt,
                         **(coords or {}))
    u0q, du0 = _eval_qp(T.Bq, T.Gs, local_values(w0, grid.ny, grid.nx))
    u0_t, du0_t = _as_tuples(u0q, du0)
    return QPContext(u=u_t, du=du_t, u0=u0_t, du0=du0_t, dt=dt,
                     **(coords or {}))


def broadcast_term(z, shape, proto: torch.Tensor) -> torch.Tensor:
    """A pointwise term broadcast to ``shape``: a tensor, or a constant
    (elast's body force) made a tensor of ``proto``'s dtype and device."""
    if not torch.is_tensor(z):
        z = proto.new_full((), z)
    return torch.broadcast_to(z, shape)


def slot_contributions(T: "TabTensors", grid: CrossedTriGrid, source_flux):
    """sum over quadrature points of w (s lambda + f . grad lambda) per cell
    and slot: [5, F, ny, nx], before the scatter."""
    source, flux = source_flux
    full_shape = (4, T.WB.shape[1], grid.ny, grid.nx)

    def stacked(terms):
        return torch.stack([broadcast_term(z, full_shape, T.WB) for z in terms])

    src = stacked(source)
    fx = stacked([f[0] for f in flux])
    fy = stacked([f[1] for f in flux])
    return (torch.einsum("tqs,ftqyx->sfyx", T.WB, src)
            + torch.einsum("tqs,ftqyx->sfyx", T.WGx, fx)
            + torch.einsum("tqs,ftqyx->sfyx", T.WGy, fy))


def _assemble(T: "TabTensors", grid: CrossedTriGrid, source_flux):
    """The slot contributions scattered to the (v, m) pair."""
    return scatter_add(slot_contributions(T, grid, source_flux), grid.vshape,
                       grid.mshape, grid.ny, grid.nx)


def make_tangent_jvp(grid: CrossedTriGrid, tangent, *,
                     device: torch.device | str, dirichlet=(),
                     dtype=torch.float64):
    """Build ``jv(w, w0, dt, v) -> (rv, rm)``, the J.v of ``make_residual``
    assembled from a hand-written pointwise ``tangent(ctx, tctx) -> (source,
    flux)`` (``tctx`` holds v and its gradients at the quadrature points):
    the same function as ``torch.func.jvp`` of the residual, without forward
    AD. The rows of each ``DirichletBC`` are identity rows (the tangent of
    ``u - g``). The state's gradient, which only a tangent that reads it
    (the anisotropic BM3's) uses, is formed as the kernels form it
    (``_eval_qp(centred=True)``)."""
    _check_grid(grid)
    T = TabTensors.make(grid, dtype, device)

    def jv(w, w0, dt, v):
        rv, rm = _assemble(T, grid, tangent(_context(T, grid, w, w0, dt, True),
                                            _context(T, grid, v, None, None)))
        for bc in dirichlet:
            rv = bc.put_rows(rv, bc.rows(v[0]))
        return rv, rm

    return jv


def make_functional(
    grid: CrossedTriGrid,
    density: Callable[[QPContext], torch.Tensor],
    *,
    device: torch.device | str,
    needs_coords: bool = False,
    dtype=torch.float64,
):
    """Build ``value(w) -> scalar tensor`` for an integral functional;
    ``needs_coords`` as in ``make_residual``."""
    _check_grid(grid)
    T = TabTensors.make(grid, dtype, device)
    coords = qpoint_tensors(grid, dtype, device) if needs_coords else {}
    full_shape = (4, grid.tab().nq, grid.ny, grid.nx)

    def value(w):
        ctx = _context(T, grid, w, None, None, coords=coords)
        e = torch.broadcast_to(density(ctx), full_shape)
        return torch.einsum("tq,tqyx->", T.wq, e)

    return value


# ---------------------------------------------------------------------------
# Dirichlet boundary conditions (bench6's phi)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Strong BC on a vertex-grid boundary line of one field.

    side: 'left' (x=0), 'right' (x=Lx), 'bottom' (y=0), 'top' (y=Ly).
    ``g`` holds the boundary values along the edge (host numpy, padded to
    the stored edge length), evaluated once at construction. Residual rows
    become ``u - g`` (FEniCS DirichletBC semantics, dolfin/bench6.py:77-90).
    The row updates are out of place, so ``torch.func`` can trace them.
    """

    field: int
    side: str
    g: np.ndarray
    index: int

    @staticmethod
    def make(grid: CrossedTriGrid, field: int, side: str, fn) -> "DirichletBC":
        if side in ("left", "right"):
            coord = np.arange(grid.ny + 1) * grid.hy
            stored = grid.vshape[0]
            index = 0 if side == "left" else grid.nx
        elif side in ("bottom", "top"):
            coord = np.arange(grid.nx + 1) * grid.hx
            stored = grid.vshape[1]
            index = 0 if side == "bottom" else grid.ny
        else:
            raise ValueError(f"unknown side {side!r}")
        g = np.zeros(stored)
        g[: coord.size] = np.broadcast_to(
            np.asarray(fn(coord), dtype=np.float64), coord.shape)
        return DirichletBC(field=field, side=side, g=g, index=index)

    @property
    def _dim(self) -> int:
        """The axis of a field plane [Y, X] that the index selects."""
        return 1 if self.side in ("left", "right") else 0

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """The BC line of a vertex array [F, Y, X]."""
        return v[self.field].select(self._dim, self.index)

    def put_rows(self, v: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """A copy of ``v`` with its BC line replaced by ``rows``."""
        plane = torch.select_scatter(v[self.field], rows, self._dim, self.index)
        return torch.select_scatter(v, plane, 0, self.field)

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


def bc_mask(grid: CrossedTriGrid, bcs, n_fields: int) -> np.ndarray | None:
    """0/1 float32 mask [F, Yv, Xv] of the Dirichlet vertex rows, or None
    without BCs (the kernels' form of ``pallas_vcycle._bc_masks``)."""
    if not bcs:
        return None
    m = np.zeros((n_fields,) + grid.vshape, np.float32)
    for bc in bcs:
        if bc.side in ("left", "right"):
            m[bc.field, : grid.ny + 1, bc.index] = 1.0
        else:
            m[bc.field, bc.index, : grid.nx + 1] = 1.0
    return m
