"""Structured crossed-triangle P1 grid: geometry + element tabulations.

Replaces DOLFIN's ``RectangleMesh(..., 'crossed')`` + dofmap machinery
(reference: dolfin/bench1.py:23). A 'crossed' mesh splits every cell of an
``nx x ny`` rectangle grid into 4 triangles by both diagonals, adding a cell
center node. P1 dofs therefore live on TWO dense grids:

- vertex grid ``[F, ny+1, nx+1]``  (y-major, x minor/lanes)
- center grid ``[F, ny, nx]``

Every cell is congruent, so element tabulations (basis values at quadrature
points, physical basis gradients, weights) are fixed small tensors — the
whole FEM assembly becomes dense einsums + shifted adds over these grids
(fem/assembly.py), and the CUDA kernels (ops/) gather per node from them. No
dofmap, no sparse matrix.

Local slot convention per cell (slots 0..4): SW, SE, NE, NW, C.
Triangles in DOLFIN ordering (cells list vertices ascending by global index;
grid vertices are numbered before center vertices, so the center is always
local vertex 2 — this fixes the affine map from the UFC reference triangle
and hence the quadrature point placement, needed for parity with FFC's
asymmetric collapsed rule):

    S: (SW, SE, C)   E: (SE, NE, C)   N: (NW, NE, C)   W: (SW, NW, C)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu_torch.fem.quadrature import TriRule, get_rule

# slot index -> cell-local coordinate factors (times hx, hy)
_SLOT_XY = np.array([
    [0.0, 0.0],   # SW
    [1.0, 0.0],   # SE
    [1.0, 1.0],   # NE
    [0.0, 1.0],   # NW
    [0.5, 0.5],   # C
])

# triangles as slot triples, DOLFIN vertex order (center always last)
_TRIS = np.array([
    [0, 1, 4],    # S
    [1, 2, 4],    # E
    [3, 2, 4],    # N
    [0, 3, 4],    # W
])


@dataclasses.dataclass(frozen=True)
class Tabulation:
    """Element tensors for one quadrature rule on one cell geometry.

    Shapes: Bq [4, nq, 5], Gs [4, 5, 2], wq [4, nq], xq [4, nq, 2] (cell-local
    physical coords of quadrature points).
    """

    Bq: np.ndarray
    Gs: np.ndarray
    wq: np.ndarray
    xq: np.ndarray

    @property
    def nq(self) -> int:
        return self.Bq.shape[1]


def tabulate(hx: float, hy: float, rule: TriRule) -> Tabulation:
    nq = rule.n
    Bq = np.zeros((4, nq, 5))
    Gs = np.zeros((4, 5, 2))
    wq = np.zeros((4, nq))
    xq = np.zeros((4, nq, 2))
    lam = np.stack(
        [1.0 - rule.points[:, 0] - rule.points[:, 1], rule.points[:, 0], rule.points[:, 1]],
        axis=1,
    )  # [nq, 3] barycentric basis values
    grad_ref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # [3, 2]
    scale = np.array([hx, hy])
    for t in range(4):
        slots = _TRIS[t]
        v = _SLOT_XY[slots] * scale  # [3, 2] physical (cell-local) vertices
        J = np.stack([v[1] - v[0], v[2] - v[0]], axis=1)  # [2, 2], columns
        detJ = np.linalg.det(J)
        JinvT = np.linalg.inv(J).T
        for k in range(3):
            Bq[t, :, slots[k]] = lam[:, k]
            Gs[t, slots[k], :] = JinvT @ grad_ref[k]
        wq[t] = rule.weights * abs(detJ)
        xq[t] = v[0] + rule.points @ J.T
    return Tabulation(Bq=Bq, Gs=Gs, wq=wq, xq=xq)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class CrossedTriGrid:
    """nx x ny cells over [0, Lx] x [0, Ly], each crossed into 4 triangles.

    ``pad_to = (py, px)`` rounds the stored Y/X dims of both grids up to
    multiples (the JAX package uses this for even sharding and lane
    alignment; the port's kernels take unpadded storage only). Padding
    regions hold zeros and are ignored by assembly (logical-region slicing);
    residuals stay exactly zero there, so Krylov dots and norms are
    unaffected.
    """

    nx: int
    ny: int
    Lx: float
    Ly: float
    rule_name: str = "ffc3"
    pad_to: tuple[int, int] = (1, 1)
    # Periodic topology in both directions (the reference implements a
    # PeriodicBoundary constraint, dolfin/pfbase.py:11-37, but never enables
    # it). Periodic grids have no duplicated right/top vertex line; their
    # wraparound assembly is not yet ported (fem/assembly.py raises).
    periodic: bool = False

    @property
    def hx(self) -> float:
        return self.Lx / self.nx

    @property
    def hy(self) -> float:
        return self.Ly / self.ny

    @property
    def n_vertices_y(self) -> int:
        return self.ny if self.periodic else self.ny + 1

    @property
    def n_vertices_x(self) -> int:
        return self.nx if self.periodic else self.nx + 1

    @property
    def vshape(self) -> tuple[int, int]:
        """Stored (padded) vertex-grid shape; logical is (ny+1, nx+1)
        (or (ny, nx) when periodic)."""
        py, px = self.pad_to
        return _round_up(self.n_vertices_y, py), _round_up(self.n_vertices_x, px)

    @property
    def mshape(self) -> tuple[int, int]:
        """Stored (padded) center-grid shape; logical is (ny, nx)."""
        py, px = self.pad_to
        return _round_up(self.ny, py), _round_up(self.nx, px)

    def pad_state(self, v: np.ndarray, m: np.ndarray):
        """Embed logical nodal arrays into padded storage."""
        Yv, Xv = self.vshape
        Ym, Xm = self.mshape
        vp = np.zeros((v.shape[0], Yv, Xv), v.dtype)
        vp[:, : self.n_vertices_y, : self.n_vertices_x] = v
        mp = np.zeros((m.shape[0], Ym, Xm), m.dtype)
        mp[:, : self.ny, : self.nx] = m
        return vp, mp

    def tab(self) -> Tabulation:
        return tabulate(self.hx, self.hy, get_rule(self.rule_name))

    # ---- node coordinates (host-side, float64) ----

    def vertex_coords(self) -> tuple[np.ndarray, np.ndarray]:
        """(x, y) arrays of the logical vertex grid."""
        Yv, Xv = self.n_vertices_y, self.n_vertices_x
        x = np.arange(Xv) * self.hx
        y = np.arange(Yv) * self.hy
        return np.broadcast_to(x, (Yv, Xv)).copy(), \
            np.broadcast_to(y[:, None], (Yv, Xv)).copy()

    def center_coords(self) -> tuple[np.ndarray, np.ndarray]:
        """(x, y) arrays of shape [ny, nx]."""
        x = (np.arange(self.nx) + 0.5) * self.hx
        y = (np.arange(self.ny) + 0.5) * self.hy
        return np.broadcast_to(x, (self.ny, self.nx)).copy(), \
            np.broadcast_to(y[:, None], (self.ny, self.nx)).copy()

    def interpolate(self, fns, dtype=np.float64):
        """Interpolate callables fn(x, y) (one per field) onto P1 nodes.

        Matches FEniCS ``Function.interpolate`` of an expression into P1:
        pointwise evaluation at every node (vertices + cell centers).
        Returns the state pytree ``(v [F, ny+1, nx+1], m [F, ny, nx])``.
        """
        vx, vy = self.vertex_coords()
        cx, cy = self.center_coords()
        v = np.stack([np.broadcast_to(f(vx, vy), vx.shape) for f in fns]).astype(dtype)
        m = np.stack([np.broadcast_to(f(cx, cy), cx.shape) for f in fns]).astype(dtype)
        return self.pad_state(v, m)

    def qpoint_coords(self) -> tuple[np.ndarray, np.ndarray]:
        """Global (x, y) of all quadrature points, each [4, nq, ny, nx]
        (coordinate-dependent forms: poisson's manufactured forcing)."""
        tab = self.tab()
        full = tab.wq.shape + (self.ny, self.nx)
        ox = np.arange(self.nx) * self.hx
        oy = np.arange(self.ny) * self.hy
        gx = tab.xq[..., 0][:, :, None, None] + ox[None, None, None, :]
        gy = tab.xq[..., 1][:, :, None, None] + oy[None, None, :, None]
        return np.broadcast_to(gx, full).copy(), np.broadcast_to(gy, full).copy()

    # ---- diagonal helpers for preconditioning ----

    def node_diagonals(self) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        """Exact diagonals of mass and stiffness operators, per node.

        Returns {name: (dv, dm)} for 'mass', 'lumped_mass', 'stiff',
        'stiff_xx' and 'stiff_yy', where dv is [ny+1, nx+1] and dm is
        [ny, nx]. Used by the pointwise
        block-Jacobi preconditioner (solve/precond.py) — replaces PETSc's SOR
        (sequential) with an equivalent-strength pointwise op.
        """
        tab = self.tab()
        # per-slot contributions, constant across cells
        mass_slot = np.einsum("tq,tqs->s", tab.wq, tab.Bq ** 2)
        lumped_slot = np.einsum("tq,tqs->s", tab.wq, tab.Bq)
        # stiffness diag: sum_t area_t * |grad lambda_slot|^2 over tris containing slot
        area_t = tab.wq.sum(axis=1)
        stiff_slot = np.einsum("t,ts->s", area_t, (tab.Gs ** 2).sum(axis=-1))
        stiff_xx_slot = np.einsum("t,ts->s", area_t, tab.Gs[..., 0] ** 2)
        stiff_yy_slot = np.einsum("t,ts->s", area_t, tab.Gs[..., 1] ** 2)
        out = {}
        for name, slot in (("mass", mass_slot), ("lumped_mass", lumped_slot),
                           ("stiff", stiff_slot), ("stiff_xx", stiff_xx_slot),
                           ("stiff_yy", stiff_yy_slot)):
            if self.periodic:
                dv = np.full((self.ny, self.nx), slot[0] + slot[1] + slot[2] + slot[3])
            else:
                dv = np.zeros((self.ny + 1, self.nx + 1))
                dv[:-1, :-1] += slot[0]
                dv[:-1, 1:] += slot[1]
                dv[1:, 1:] += slot[2]
                dv[1:, :-1] += slot[3]
            dm = np.full((self.ny, self.nx), slot[4])
            out[name] = (dv, dm)
        return out
