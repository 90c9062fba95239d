"""Structured 3D tetrahedral P1 grid (DOLFIN BoxMesh equivalent).

Counterpart of ``pfhubbenchmarks_tpu/fem/grid3d.py`` (numpy only). Every
hex cell of an ``nx x ny x nz`` grid is split into 6 tetrahedra around its
main diagonal (the Kuhn/Freudenthal split DOLFIN uses), so the P1 dofs live
on ONE dense vertex grid ``[F, nz+1, ny+1, nx+1]``: no cell-centre nodes in
3D.

Local corner slots: s = 4*dz + 2*dy + dx (x fastest, matching DOLFIN's
row-major global numbering, so ascending slot order is ascending global
order and each tet's vertex list below is already DOLFIN-sorted).

State: ``w = (v,)``, a 1-tuple, so the pair linear algebra of
solve/tree.py, the Krylov solver and Newton apply unchanged.
``qpoint_coords`` gives the quadrature points' global coordinates, which
coordinate-dependent forms read (poisson3d).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pfhubbenchmarks_tpu_torch.fem.quadrature import TetRule, get_tet_rule

# corner slot -> (dx, dy, dz)
_SLOT_XYZ = np.array([[x, y, z] for z in (0, 1) for y in (0, 1) for x in (0, 1)])

# 6 Kuhn tets around the 0-7 diagonal (DOLFIN BoxMesh split, vertex-sorted)
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 4, 5, 7],
    [0, 2, 3, 7],
    [0, 4, 6, 7],
    [0, 2, 6, 7],
])


@dataclasses.dataclass(frozen=True)
class Tabulation3D:
    Bq: np.ndarray   # [6, nq, 8]
    Gs: np.ndarray   # [6, 8, 3]
    wq: np.ndarray   # [6, nq]
    xq: np.ndarray   # [6, nq, 3] cell-local quadrature point coords

    @property
    def nq(self) -> int:
        return self.Bq.shape[1]


def tabulate3d(hx: float, hy: float, hz: float, rule: TetRule) -> Tabulation3D:
    nq = rule.n
    Bq = np.zeros((6, nq, 8))
    Gs = np.zeros((6, 8, 3))
    wq = np.zeros((6, nq))
    xq = np.zeros((6, nq, 3))
    lam = np.concatenate(
        [1.0 - rule.points.sum(axis=1, keepdims=True), rule.points], axis=1)  # [nq, 4]
    grad_ref = np.array([[-1.0, -1.0, -1.0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    scale = np.array([hx, hy, hz])
    for t in range(6):
        slots = _TETS[t]
        v = _SLOT_XYZ[slots] * scale  # [4, 3]
        J = np.stack([v[1] - v[0], v[2] - v[0], v[3] - v[0]], axis=1)
        detJ = np.linalg.det(J)
        JinvT = np.linalg.inv(J).T
        for k in range(4):
            Bq[t, :, slots[k]] = lam[:, k]
            Gs[t, slots[k], :] = JinvT @ grad_ref[k]
        wq[t] = rule.weights * abs(detJ)
        xq[t] = lam @ v  # barycentric combination of the tet's vertices
    return Tabulation3D(Bq=Bq, Gs=Gs, wq=wq, xq=xq)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class TetGrid:
    """nx x ny x nz hex cells over [0,Lx] x [0,Ly] x [0,Lz], 6 tets each."""

    nx: int
    ny: int
    nz: int
    Lx: float
    Ly: float
    Lz: float
    rule_name: str = "ffc3"
    pad_to: tuple[int, int, int] = (1, 1, 1)

    dim = 3
    n_state_leaves = 1

    @property
    def hx(self) -> float:
        return self.Lx / self.nx

    @property
    def hy(self) -> float:
        return self.Ly / self.ny

    @property
    def hz(self) -> float:
        return self.Lz / self.nz

    @property
    def vshape(self) -> tuple[int, int, int]:
        pz, py, px = self.pad_to
        return (_round_up(self.nz + 1, pz), _round_up(self.ny + 1, py),
                _round_up(self.nx + 1, px))

    @property
    def n_vertices(self) -> int:
        return (self.nz + 1) * (self.ny + 1) * (self.nx + 1)

    def tab(self) -> Tabulation3D:
        return tabulate3d(self.hx, self.hy, self.hz, get_tet_rule(self.rule_name))

    def qpoint_coords(self):
        """Global (x, y, z) of all quadrature points, each [6, nq, nz, ny,
        nx] (coordinate-dependent forms: poisson3d's forcing)."""
        tab = self.tab()
        full = tab.wq.shape + (self.nz, self.ny, self.nx)
        ox = np.arange(self.nx) * self.hx
        oy = np.arange(self.ny) * self.hy
        oz = np.arange(self.nz) * self.hz
        gx = tab.xq[..., 0][:, :, None, None, None] + ox[None, None, None, None, :]
        gy = tab.xq[..., 1][:, :, None, None, None] + oy[None, None, None, :, None]
        gz = tab.xq[..., 2][:, :, None, None, None] + oz[None, None, :, None, None]
        return (np.broadcast_to(gx, full).copy(),
                np.broadcast_to(gy, full).copy(),
                np.broadcast_to(gz, full).copy())

    def vertex_coords(self):
        z, y, x = np.meshgrid(np.arange(self.nz + 1) * self.hz,
                              np.arange(self.ny + 1) * self.hy,
                              np.arange(self.nx + 1) * self.hx, indexing="ij")
        return x, y, z

    def interpolate(self, fns, dtype=np.float64):
        """Pointwise nodal interpolation; returns the padded state ``(v,)``."""
        x, y, z = self.vertex_coords()
        v = np.stack([np.broadcast_to(f(x, y, z), x.shape) for f in fns]).astype(dtype)
        Z, Y, X = self.vshape
        vp = np.zeros((v.shape[0], Z, Y, X), dtype)
        vp[:, : self.nz + 1, : self.ny + 1, : self.nx + 1] = v
        return (vp,)

    def node_diagonals(self) -> dict[str, np.ndarray]:
        """Exact operator diagonals per vertex: mass, stiff per axis."""
        tab = self.tab()
        mass_slot = np.einsum("tq,tqs->s", tab.wq, tab.Bq ** 2)
        vol_t = tab.wq.sum(axis=1)
        stiff_ax = [np.einsum("t,ts->s", vol_t, tab.Gs[..., d] ** 2) for d in range(3)]
        out = {}
        shape = (self.nz + 1, self.ny + 1, self.nx + 1)
        for name, slot in [("mass", mass_slot)] + [
                (f"stiff_{d}", stiff_ax[d]) for d in range(3)]:
            dv = np.zeros(shape)
            for s in range(8):
                dx, dy, dz = _SLOT_XYZ[s]
                dv[dz : self.nz + dz, dy : self.ny + dy, dx : self.nx + dx] += slot[s]
            out[name] = dv
        return out
