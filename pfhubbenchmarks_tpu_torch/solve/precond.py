"""Pointwise block-Jacobi preconditioner, derived from the model physics.

Counterpart of ``pfhubbenchmarks_tpu/solve/precond.py:make_block_jacobi``.
Per grid node, the exact F x F diagonal block of the Jacobian

    P_node = dsource/du * mass_diag(node) +
             dflux_x/d(du_x) * stiff_xx_diag(node) +
             dflux_y/d(du_y) * stiff_yy_diag(node)

at nodal values, one-hot field tangents, then a batched F x F inverse
(``small_inv``). Two forms build the same blocks:

- ``make_block_jacobi_tangent`` (2D) and ``make_block_jacobi3d`` take the
  pointwise derivative blocks from the benchmark's hand-written tangent
  with one-hot directions. The 2D one is the plain version of kernel N
  (ops/node_blocks.py), which builds the planes of every 2D multigrid level
  on the card; on CPU tensors the multigrid build runs it.
- ``make_block_jacobi`` takes them from ``torch.func.jvp`` of the model's
  ``terms``, as the JAX package takes them from ``jax.jvp``. It is off the
  main paths: kernel N's library comparison, and the callers that hold a
  build against the JAX package's.

Applying the inverse is kernel B (ops/lmr.block_jacobi_apply), or its body
inside kernel L and the chain kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import QPContext
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.lmr import block_jacobi_apply


def _pointwise_eval(terms, u, dus, u0, dt, shape):
    """Evaluate (source, flux_x, flux_y) stacked [3, F, ...] at nodes."""
    n = u.shape[0]
    zeros = torch.zeros_like(u[0])
    ctx = QPContext(
        u=tuple(u[i] for i in range(n)),
        du=tuple(tuple(dus[d][i] for d in range(2)) for i in range(n)),
        u0=tuple(u0[i] for i in range(n)),
        du0=tuple((zeros, zeros) for _ in range(n)),
        dt=dt)
    s, f = terms(ctx)

    def b(z):
        return torch.broadcast_to(z, shape[1:])

    return torch.stack([torch.stack([b(si) for si in s])]
                       + [torch.stack([b(fi[d]) for fi in f]) for d in range(2)])


def small_inv(A):
    """Batched inverse of [..., F, F] by unrolled Gauss-Jordan, as the JAX
    package does (the blocks are diagonally dominant: no pivoting)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    aug = torch.cat([A, torch.broadcast_to(eye, A.shape)], dim=-1)
    for i in range(n):
        piv = aug[..., i, :] / aug[..., i, i][..., None]
        rows = [piv if r == i else aug[..., r, :] - aug[..., r, i][..., None] * piv
                for r in range(n)]
        aug = torch.stack(rows, dim=-2)
    return aug[..., :, n:]


def padded_diagonals(grid: CrossedTriGrid, device, dtype=torch.float32):
    """The node diagonals of mass, stiff_xx and stiff_yy
    (``grid.node_diagonals()``) as ((v, m), (v, m), (v, m)) tensors of the
    stored shapes, padded with 1.0 (padding blocks stay well-conditioned;
    state and residual are zero there)."""
    diags = grid.node_diagonals()

    def pad(dv, dm):
        pv = np.ones(grid.vshape)
        pv[: dv.shape[0], : dv.shape[1]] = dv
        pm = np.ones(grid.mshape)
        pm[: dm.shape[0], : dm.shape[1]] = dm
        return (torch.as_tensor(pv, dtype=dtype, device=device),
                torch.as_tensor(pm, dtype=dtype, device=device))

    return tuple(pad(*diags[k]) for k in ("mass", "stiff_xx", "stiff_yy"))


def _unit_rows(Pv, dirichlet, n_fields):
    """Row ``field`` of the vertex blocks of each ``DirichletBC`` set to the
    unit row (the residual row is ``u - g``), in place, before the inverse."""
    for bc in dirichlet:
        row = torch.zeros(n_fields, dtype=Pv.dtype, device=Pv.device)
        row[bc.field] = 1.0
        if bc.side in ("left", "right"):
            Pv[:, bc.index, bc.field, :] = row
        else:
            Pv[bc.index, :, bc.field, :] = row


def _planes(Pv_inv, Pm_inv):
    """[Y, X, F, F] inverses -> the contiguous [F, F, Y, X] planes, wrapped
    as ``Minv`` (kernel B's apply) with ``Minv.pinv_planes``."""
    planes = (Pv_inv.permute(2, 3, 0, 1).contiguous(),
              Pm_inv.permute(2, 3, 0, 1).contiguous())

    def Minv(r):
        return block_jacobi_apply(planes, r)

    Minv.pinv_planes = planes
    return Minv


def make_block_jacobi(grid: CrossedTriGrid, terms, n_fields: int, *,
                      device: torch.device | str, dirichlet=(),
                      dtype=torch.float32):
    """Returns ``build(w, w0, dt) -> Minv``; ``Minv(r)`` applies P^-1 and
    ``Minv.pinv_planes`` holds the inverses as contiguous [F, F, Y, X]
    planes (the layout kernel B reads). On the vertex blocks of each
    ``DirichletBC`` row, row ``field`` of the block is the unit row (the
    residual row is ``u - g``), set before the inverse."""
    (mass_v, mass_m), (sxx_v, sxx_m), (syy_v, syy_m) = padded_diagonals(
        grid, device, dtype)

    def blocks_for(u, u0, dt, mass_d, sxx_d, syy_d):
        """u [F, Y, X] -> P [Y, X, F, F]."""
        shape = u.shape
        zer = torch.zeros_like(u)

        def f(uu, dx, dy):
            return _pointwise_eval(terms, uu, (dx, dy), u0, dt, shape)

        cols = []
        for j in range(n_fields):
            e = torch.zeros_like(u)
            e[j] = 1.0
            _, t_u = torch.func.jvp(lambda a: f(a, zer, zer), (u,), (e,))
            _, t_dx = torch.func.jvp(lambda a: f(u, a, zer), (zer,), (e,))
            _, t_dy = torch.func.jvp(lambda a: f(u, zer, a), (zer,), (e,))
            cols.append(t_u[0] * mass_d + t_dx[1] * sxx_d + t_dy[2] * syy_d)
        P = torch.stack(cols, dim=-1)      # [F, Y, X, F] (row, y, x, col)
        return torch.movedim(P, 0, -2)     # [Y, X, F, F]

    def build(w, w0, dt):
        with _lib.timed("jvp_blocks", w[0]):
            v, m = (a.to(dtype) for a in w)
            v0, m0 = (a.to(dtype) for a in w0)
            Pv = blocks_for(v, v0, dt, mass_v, sxx_v, syy_v)
            _unit_rows(Pv, dirichlet, n_fields)
            return _planes(small_inv(Pv),
                           small_inv(blocks_for(m, m0, dt, mass_m, sxx_m,
                                                syy_m)))

    return build


def make_block_jacobi_tangent(grid: CrossedTriGrid, tangent, n_fields: int, *,
                              device: torch.device | str, dirichlet=(),
                              dtype=torch.float32):
    """The 2D twin of ``make_block_jacobi3d`` and the plain version of
    kernel N (ops/node_blocks.py): the blocks of ``make_block_jacobi`` from
    the benchmark's hand-written pointwise ``tangent(ctx, tctx)`` (bench1's
    and bench6's ``terms_tangent``, bench2's ``make_terms_tangent(p, ne,
    split)``, bench3's ``terms_tangent``) with one-hot directions: the value
    direction for the source, one gradient axis at a time for the fluxes,
    at zero state gradients, which gives the numbers ``torch.func.jvp`` of
    ``terms`` gives there, without forward AD. The unit rows of
    ``dirichlet``, then ``small_inv``. Returns ``build(w, w0, dt) ->
    Minv`` with ``Minv.pinv_planes`` the [F, F, Y, X] planes."""
    (mass_v, mass_m), (sxx_v, sxx_m), (syy_v, syy_m) = padded_diagonals(
        grid, device, dtype)
    F = n_fields

    def blocks_for(u, u0, dt, mass_d, sxx_d, syy_d):
        """u [F, Y, X] -> P [Y, X, F, F]."""
        zer = torch.zeros_like(u[0])
        one = torch.ones_like(u[0])
        grad0 = tuple((zer, zer) for _ in range(F))
        ctx = QPContext(u=tuple(u[i] for i in range(F)), du=grad0,
                        u0=tuple(u0[i] for i in range(F)), du0=grad0, dt=dt)

        def along(u_dir, du_dir):
            return tangent(ctx, QPContext(u=u_dir, du=du_dir, u0=None,
                                          du0=None, dt=None))

        def stacked(parts):
            return torch.stack([torch.broadcast_to(p, u.shape[1:])
                                for p in parts])

        zeros = tuple(zer for _ in range(F))
        cols = []
        for j in range(F):
            e = tuple(one if i == j else zer for i in range(F))
            src, _ = along(e, grad0)
            _, flux_x = along(zeros, tuple((e[i], zer) for i in range(F)))
            _, flux_y = along(zeros, tuple((zer, e[i]) for i in range(F)))
            cols.append(stacked(src) * mass_d
                        + stacked([fl[0] for fl in flux_x]) * sxx_d
                        + stacked([fl[1] for fl in flux_y]) * syy_d)
        P = torch.stack(cols, dim=-1)      # [F, Y, X, F] (row, y, x, col)
        return torch.movedim(P, 0, -2)     # [Y, X, F, F]

    def build(w, w0, dt):
        v, m = (a.to(dtype) for a in w)
        v0, m0 = (a.to(dtype) for a in w0)
        Pv = blocks_for(v, v0, dt, mass_v, sxx_v, syy_v)
        _unit_rows(Pv, dirichlet, F)
        return _planes(small_inv(Pv),
                       small_inv(blocks_for(m, m0, dt, mass_m, sxx_m, syy_m)))

    return build


def make_block_jacobi3d(grid: TetGrid, tangent, n_fields: int, *,
                        device: torch.device | str, dirichlet=(),
                        dtype=torch.float32):
    """3D single-grid form (``pfhubbenchmarks_tpu/solve/precond.py:
    make_block_jacobi3d``): per vertex the F x F block

        P_node = dsource/du * mass(node) + sum_d dflux_d/d(du_d) * stiff_d(node)

    with the diagonals of ``TetGrid.node_diagonals``. The pointwise
    derivative blocks come from the benchmark's hand-written ``tangent(ctx,
    tctx)`` with one-hot directions (the value direction for the source, one
    gradient axis at a time for the fluxes), which gives the numbers
    ``jax.jvp`` of ``terms`` gives there, without forward AD. Returns
    ``build(w, w0, dt) -> Minv``; ``Minv.pinv_planes`` is the 1-tuple of
    [F, F, Z, Y, X] inverse planes kernel B reads. The rows of each
    ``DirichletBC3D`` in ``dirichlet`` are unit rows (the residual row is
    ``u - g``), as in the JAX package (``precond.py:198-208``)."""
    d = grid.node_diagonals()
    Z, Y, X = grid.vshape

    def _pad(a):
        p = np.ones((Z, Y, X))
        p[: a.shape[0], : a.shape[1], : a.shape[2]] = a
        return torch.as_tensor(p, dtype=dtype, device=device)

    mass_d = _pad(d["mass"])
    stiff_d = [_pad(d[f"stiff_{ax}"]) for ax in range(3)]
    F = n_fields

    def build(w, w0, dt):
        (u,) = (a.to(dtype) for a in w)
        (u0,) = (a.to(dtype) for a in w0)
        zer = torch.zeros_like(u[0])
        one = torch.ones_like(u[0])
        grad0 = tuple((zer, zer, zer) for _ in range(F))
        ctx = QPContext(u=tuple(u[i] for i in range(F)), du=grad0,
                        u0=tuple(u0[i] for i in range(F)), du0=grad0, dt=dt)
        cols = []
        for j in range(F):
            e = tuple(one if i == j else zer for i in range(F))
            src, _ = tangent(ctx, QPContext(u=e, du=grad0, u0=None, du0=None,
                                            dt=None))
            col = torch.stack([torch.broadcast_to(s, u.shape[1:])
                               for s in src]) * mass_d
            for ax in range(3):
                du = tuple(tuple(one if (i == j and a == ax) else zer
                                 for a in range(3)) for i in range(F))
                _, flux = tangent(ctx, QPContext(
                    u=tuple(zer for _ in range(F)), du=du, u0=None, du0=None,
                    dt=None))
                col = col + torch.stack([torch.broadcast_to(fl[ax], u.shape[1:])
                                         for fl in flux]) * stiff_d[ax]
            cols.append(col)
        P = torch.movedim(torch.stack(cols, dim=-1), 0, -2)   # [Z, Y, X, F, F]
        for bc in dirichlet:
            row = torch.zeros(F, dtype=P.dtype, device=P.device)
            row[bc.field] = 1.0
            at = [slice(None)] * 3
            at[bc.axis] = bc.index
            P[(*at, bc.field)] = row
        planes = (small_inv(P).permute(3, 4, 0, 1, 2).contiguous(),)

        def Minv(r):
            return block_jacobi_apply(planes, r)

        Minv.pinv_planes = planes
        return Minv

    return build
