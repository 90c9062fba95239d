"""3D grid transfers for the nested Kuhn-tet hierarchy.

Counterpart of ``pfhubbenchmarks_tpu/solve/transfer3d.py``. The Kuhn split
is self-refining: ratio-R refinement of a Kuhn grid is the Kuhn split of the
refined grid, so coarse P1 is a subspace of fine P1 and prolongation is
evaluation at the fine nodes (``_kuhn_weights``). For R = 2 every fine node
is a coarse node or the midpoint of a coarse edge, face diagonal or main
diagonal (``prolong3d``); any R is the general form (``prolong3d_general``:
interior classes, then the last plane of each axis as a 2D problem, the last
lines as 1D interpolation, and the far corner).

Restriction is the exact transpose of the prolongation, written out (the
JAX package takes ``jax.linear_transpose`` for the general ratio);
injection restricts states. The JAX package computes these in XLA, outside
any Pallas kernel, and so does the port: plain torch, on the card too. Each
factory returns ``apply(state) -> state`` on 1-leaf states ``(v,)``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid

_PARITIES = list(itertools.product((0, 1), repeat=3))  # (pz, py, px)


def _kuhn_weights(x: float, y: float, z: float) -> np.ndarray:
    """P1-on-Kuhn-tets interpolation weights at (x, y, z) in [0,1]^3 over the
    8 cube corners, indexed [dz, dy, dx]: with the coordinates sorted
    s1 >= s2 >= s3 (axes a, b, c) the interpolant is (1-s1) f(0) + (s1-s2)
    f(e_a) + (s2-s3) f(e_a+e_b) + s3 f(1,1,1)."""
    coords = np.array([x, y, z])
    order = np.argsort(-coords, kind="stable")
    s = coords[order]
    verts = [np.zeros(3, int)]
    acc = np.zeros(3, int)
    for k in range(3):
        acc = acc.copy()
        acc[order[k]] = 1
        verts.append(acc)
    wts = [1.0 - s[0], s[0] - s[1], s[1] - s[2], s[2]]
    W = np.zeros((2, 2, 2))
    for w, v in zip(wts, verts):
        W[v[2], v[1], v[0]] += w
    return W


def _kuhn_weights2(x: float, y: float) -> np.ndarray:
    """The Kuhn interpolation restricted to a face of the cube (cut by its
    (0,0)-(1,1) diagonal): weights over the corners [d1, d2]."""
    s1, s2 = (x, y) if x >= y else (y, x)
    verts = ([(0, 1), (1, 1)] if x >= y else [(1, 0), (1, 1)])
    W = np.zeros((2, 2))
    W[0, 0] += 1.0 - s1
    W[verts[0][0], verts[0][1]] += s1 - s2
    W[1, 1] += s2
    return W


def _padded(vc, grid: TetGrid):
    """[F, nz+1, ny+1, nx+1] -> the state (v,) in ``grid``'s storage shape."""
    out = vc.new_zeros((vc.shape[0],) + grid.vshape)
    out[:, : grid.nz + 1, : grid.ny + 1, : grid.nx + 1] = vc
    return (out,)


def _cached(tables: dict, name: str, a: np.ndarray, like: torch.Tensor):
    """Host table ``a`` as a tensor of ``like``'s dtype and device, made once
    per (name, dtype, device)."""
    key = (name, like.dtype, like.device)
    if key not in tables:
        tables[key] = torch.as_tensor(a, dtype=like.dtype, device=like.device)
    return tables[key]


# ---- ratio 2 ---------------------------------------------------------------

def prolong3d(coarse: TetGrid, fine: TetGrid):
    nzc, nyc, nxc = coarse.nz, coarse.ny, coarse.nx

    def apply(wc):
        vc = wc[0][:, : nzc + 1, : nyc + 1, : nxc + 1]
        vf = vc.new_zeros((vc.shape[0],) + fine.vshape)
        for pz, py, px in _PARITIES:
            lo = vc[:, : nzc + 1 - pz, : nyc + 1 - py, : nxc + 1 - px]
            hi = vc[:, pz:, py:, px:]
            val = lo if (pz | py | px) == 0 else 0.5 * (lo + hi)
            vf[:, pz: 2 * nzc + 1: 2, py: 2 * nyc + 1: 2,
               px: 2 * nxc + 1: 2] = val
        return (vf,)

    return apply


def restrict3d(coarse: TetGrid, fine: TetGrid):
    nzc, nyc, nxc = coarse.nz, coarse.ny, coarse.nx

    def apply(wf):
        vf = wf[0][:, : 2 * nzc + 1, : 2 * nyc + 1, : 2 * nxc + 1]
        vc = vf[:, 0::2, 0::2, 0::2].clone()
        for pz, py, px in _PARITIES:
            if (pz | py | px) == 0:
                continue
            sub = 0.5 * vf[:, pz::2, py::2, px::2]   # [F, nzc+1-pz, ...]
            vc[:, : nzc + 1 - pz, : nyc + 1 - py, : nxc + 1 - px] += sub
            vc[:, pz:, py:, px:] += sub
        return _padded(vc, coarse)

    return apply


# ---- any integer ratio -----------------------------------------------------

def _ratio(coarse: TetGrid, fine: TetGrid) -> int:
    R = fine.nz // coarse.nz
    if (fine.nz, fine.ny, fine.nx) != (R * coarse.nz, R * coarse.ny,
                                       R * coarse.nx):
        raise ValueError(f"not a ratio-R pair: {fine.nz, fine.ny, fine.nx} "
                         f"over {coarse.nz, coarse.ny, coarse.nx}")
    return R


def _tables(R: int):
    """Interior class weights [R^3, 8] (corners dz, dy, dx), face class
    weights [R^2, 4] (corners d1, d2) and the 1D fractions [R]."""
    w3 = np.array([_kuhn_weights(px / R, py / R, pz / R).reshape(8)
                   for pz in range(R) for py in range(R) for px in range(R)])
    w2 = np.array([_kuhn_weights2(p2 / R, p1 / R).reshape(4)
                   for p1 in range(R) for p2 in range(R)])
    return w3, w2, np.arange(R) / R


def prolong3d_general(coarse: TetGrid, fine: TetGrid):
    """Ratio-R nested Kuhn-P1 prolongation (any integer R): bench1_3d's
    25^3 -> 5^3 pair has R = 5."""
    nzc, nyc, nxc = coarse.nz, coarse.ny, coarse.nx
    R = _ratio(coarse, fine)
    w3_np, w2_np, frac_np = _tables(R)
    tables = {}

    def face(plane, n1, n2):
        """plane [F, n1+1, n2+1] -> [F, R n1, R n2] interior classes."""
        F = plane.shape[0]
        c = torch.stack([plane[:, d1: n1 + d1, d2: n2 + d2]
                         for d1 in (0, 1) for d2 in (0, 1)])
        cl = torch.tensordot(_cached(tables, "w2", w2_np, plane), c, dims=1)
        return cl.reshape(R, R, F, n1, n2).permute(2, 3, 0, 4, 1).reshape(
            F, R * n1, R * n2)

    def edge(line, n):
        """[F, n+1] -> [F, R n] by 1D linear interpolation."""
        f = _cached(tables, "frac", frac_np, line)
        out = ((1.0 - f)[None, None, :] * line[:, :-1, None]
               + f[None, None, :] * line[:, 1:, None])
        return out.reshape(line.shape[0], R * n)

    def apply(wc):
        vc = wc[0][:, : nzc + 1, : nyc + 1, : nxc + 1]
        F = vc.shape[0]
        corners = torch.stack([vc[:, dz: nzc + dz, dy: nyc + dy, dx: nxc + dx]
                               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)])
        cls = torch.tensordot(_cached(tables, "w3", w3_np, vc), corners, dims=1)
        body = cls.reshape(R, R, R, F, nzc, nyc, nxc).permute(
            3, 4, 0, 5, 1, 6, 2).reshape(F, R * nzc, R * nyc, R * nxc)
        Zf, Yf, Xf = R * nzc, R * nyc, R * nxc
        vf = vc.new_zeros((F,) + fine.vshape)
        vf[:, :Zf, :Yf, :Xf] = body
        # the last plane of each axis: the 2D problem on that face
        vf[:, Zf, :Yf, :Xf] = face(vc[:, nzc], nyc, nxc)
        vf[:, :Zf, Yf, :Xf] = face(vc[:, :, nyc], nzc, nxc)
        vf[:, :Zf, :Yf, Xf] = face(vc[:, :, :, nxc], nzc, nyc)
        # the last lines: 1D interpolation; the far corner exactly
        vf[:, Zf, Yf, :Xf] = edge(vc[:, nzc, nyc, :], nxc)
        vf[:, Zf, :Yf, Xf] = edge(vc[:, nzc, :, nxc], nyc)
        vf[:, :Zf, Yf, Xf] = edge(vc[:, :, nyc, nxc], nzc)
        vf[:, Zf, Yf, Xf] = vc[:, nzc, nyc, nxc]
        return (vf,)

    return apply


def restrict3d_general(coarse: TetGrid, fine: TetGrid):
    """The exact transpose of ``prolong3d_general``, written out: each piece
    of the prolongation (interior classes, the three last planes, the three
    last lines, the corner) writes a disjoint part of the fine grid, so the
    transpose adds each piece's transpose into the coarse grid."""
    nzc, nyc, nxc = coarse.nz, coarse.ny, coarse.nx
    R = _ratio(coarse, fine)
    w3_np, w2_np, frac_np = _tables(R)
    tables = {}

    def face_t(g, plane, n1, n2):
        """Adds face^T(g [F, R n1, R n2]) into ``plane`` [F, n1+1, n2+1]."""
        F = g.shape[0]
        cl = g.reshape(F, n1, R, n2, R).permute(2, 4, 0, 1, 3).reshape(
            R * R, F, n1, n2)
        c = torch.tensordot(_cached(tables, "w2t", w2_np.T, g), cl, dims=1)
        for k, (d1, d2) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            plane[:, d1: n1 + d1, d2: n2 + d2] += c[k]

    def edge_t(g, line, n):
        """Adds edge^T(g [F, R n]) into ``line`` [F, n+1]."""
        f = _cached(tables, "frac", frac_np, g)
        gg = g.reshape(g.shape[0], n, R)
        line[:, :-1] += (gg * (1.0 - f)).sum(-1)
        line[:, 1:] += (gg * f).sum(-1)

    def apply(wf):
        vf = wf[0]
        F = vf.shape[0]
        Zf, Yf, Xf = R * nzc, R * nyc, R * nxc
        vc = vf.new_zeros((F, nzc + 1, nyc + 1, nxc + 1))
        cls = vf[:, :Zf, :Yf, :Xf].reshape(F, nzc, R, nyc, R, nxc, R).permute(
            2, 4, 6, 0, 1, 3, 5).reshape(R ** 3, F, nzc, nyc, nxc)
        corners = torch.tensordot(_cached(tables, "w3t", w3_np.T, vf), cls,
                                  dims=1)
        for k, (dz, dy, dx) in enumerate(itertools.product((0, 1), repeat=3)):
            vc[:, dz: nzc + dz, dy: nyc + dy, dx: nxc + dx] += corners[k]
        face_t(vf[:, Zf, :Yf, :Xf], vc[:, nzc], nyc, nxc)
        face_t(vf[:, :Zf, Yf, :Xf], vc[:, :, nyc], nzc, nxc)
        face_t(vf[:, :Zf, :Yf, Xf], vc[:, :, :, nxc], nzc, nyc)
        edge_t(vf[:, Zf, Yf, :Xf], vc[:, nzc, nyc, :], nxc)
        edge_t(vf[:, Zf, :Yf, Xf], vc[:, nzc, :, nxc], nyc)
        edge_t(vf[:, :Zf, Yf, Xf], vc[:, :, nyc, nxc], nzc)
        vc[:, nzc, nyc, nxc] += vf[:, Zf, Yf, Xf]
        return _padded(vc, coarse)

    return apply


def inject_state3d_general(coarse: TetGrid, fine: TetGrid):
    nzc, nyc, nxc = coarse.nz, coarse.ny, coarse.nx
    R = _ratio(coarse, fine)

    def apply(wf):
        vc = wf[0][:, : R * nzc + 1: R, : R * nyc + 1: R, : R * nxc + 1: R]
        return _padded(vc, coarse)

    return apply


def prolong3d_any(coarse: TetGrid, fine: TetGrid):
    return (prolong3d if fine.nz == 2 * coarse.nz
            else prolong3d_general)(coarse, fine)


def restrict3d_any(coarse: TetGrid, fine: TetGrid):
    return (restrict3d if fine.nz == 2 * coarse.nz
            else restrict3d_general)(coarse, fine)


def inject3d_any(coarse: TetGrid, fine: TetGrid):
    """Injection is one strided slice for every ratio."""
    return inject_state3d_general(coarse, fine)
