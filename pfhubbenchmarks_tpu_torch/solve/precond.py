"""Preconditioners derived from the model physics.

Counterpart of ``pfhubbenchmarks_tpu/solve/precond.py``.

Pointwise block-Jacobi: per grid node, the exact F x F diagonal block of
the Jacobian

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
- ``make_block_jacobi`` and ``make_block_jacobi3d_terms`` take them from
  ``torch.func.jvp`` of the model's ``terms``, as the JAX package takes them
  from ``jax.jvp``. They are the preconditioner of the f64 linear branch
  (poisson, poisson3d: ``precond='block_jacobi'``, in f64), kernel N's
  library comparison, and the callers that hold a build against the JAX
  package's.

Applying an f32 inverse is kernel B (ops/lmr.block_jacobi_apply), or its
body inside kernel L and the chain kernels; an f64 inverse, which only the
f64 Krylov branch builds, is applied by the einsum (kernel B is f32), as the
JAX package applies it in XLA.

``make_dense_precond`` (elast): the whole Jacobian by chunked forward-mode
columns, row-equilibrated and factored by ``torch.linalg.lu_factor`` in f64,
and its explicit inverse, applied as ``A (d r)``: the JAX package's LAPACK
form. ``make_identity_precond``: ``precond='none'``. ``BUILDERS`` maps the
``precond`` names other than 'gmg' to their builders.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from pfhubbenchmarks_tpu_torch.fem.assembly import (QPContext, broadcast_term,
                                                    make_residual)
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.lmr import (block_jacobi_apply,
                                               block_jacobi_apply_plain)
from pfhubbenchmarks_tpu_torch.solve import tree as tr


def _pointwise_eval(terms, u, dus, u0, dt, shape, needs_coords=False):
    """Evaluate (source, flux_0..flux_{dim-1}) stacked [1 + dim, F, ...] at
    nodes, ``dim = len(dus)``. A model that reads coordinates gets 0.0 for
    each (JAX ``precond.py:27-51``): forcing terms f(x) do not enter the
    Jacobian's diagonal blocks."""
    dim = len(dus)
    n = u.shape[0]
    zeros = torch.zeros_like(u[0])
    coords = ({k: u.new_zeros(()) for k in "xyz"[:dim]} if needs_coords
              else {})
    ctx = QPContext(
        u=tuple(u[i] for i in range(n)),
        du=tuple(tuple(dus[d][i] for d in range(dim)) for i in range(n)),
        u0=tuple(u0[i] for i in range(n)),
        du0=tuple(tuple(zeros for _ in range(dim)) for _ in range(n)),
        dt=dt, **coords)
    s, f = terms(ctx)

    def b(z):
        return broadcast_term(z, shape[1:], zeros)

    return torch.stack([torch.stack([b(si) for si in s])]
                       + [torch.stack([b(fi[d]) for fi in f])
                          for d in range(dim)])


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


def _apply(planes):
    """``Minv(r)`` over [F, F, ...] inverse planes, with
    ``Minv.pinv_planes``: kernel B for f32 planes, the einsum for f64 ones
    (the f64 Krylov branch; kernel B is f32)."""
    apply = (block_jacobi_apply if planes[0].dtype == torch.float32
             else block_jacobi_apply_plain)

    def Minv(r):
        return apply(planes, r)

    Minv.pinv_planes = planes
    return Minv


def _planes(Pv_inv, Pm_inv):
    """[Y, X, F, F] inverses -> the contiguous [F, F, Y, X] planes, wrapped
    by ``_apply``."""
    return _apply((Pv_inv.permute(2, 3, 0, 1).contiguous(),
                   Pm_inv.permute(2, 3, 0, 1).contiguous()))


def make_block_jacobi(grid: CrossedTriGrid, terms, n_fields: int, *,
                      device: torch.device | str, dirichlet=(),
                      dtype=torch.float32, needs_coords: bool = False):
    """Returns ``build(w, w0, dt) -> Minv``; ``Minv(r)`` applies P^-1 and
    ``Minv.pinv_planes`` holds the inverses as contiguous [F, F, Y, X]
    planes (the layout kernel B reads). On the vertex blocks of each
    ``DirichletBC`` row, row ``field`` of the block is the unit row (the
    residual row is ``u - g``), set before the inverse. ``needs_coords``
    systems get coordinate-independent blocks (``_pointwise_eval``)."""
    (mass_v, mass_m), (sxx_v, sxx_m), (syy_v, syy_m) = padded_diagonals(
        grid, device, dtype)

    def blocks_for(u, u0, dt, mass_d, sxx_d, syy_d):
        """u [F, Y, X] -> P [Y, X, F, F]."""
        shape = u.shape
        zer = torch.zeros_like(u)

        def f(uu, dx, dy):
            return _pointwise_eval(terms, uu, (dx, dy), u0, dt, shape,
                                   needs_coords)

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


def _diagonals3d(grid: TetGrid, device, dtype):
    """The mass diagonal and the three axis stiffness diagonals of
    ``grid.node_diagonals()``, padded to the stored shape with 1.0."""
    d = grid.node_diagonals()
    Z, Y, X = grid.vshape

    def _pad(a):
        p = np.ones((Z, Y, X))
        p[: a.shape[0], : a.shape[1], : a.shape[2]] = a
        return torch.as_tensor(p, dtype=dtype, device=device)

    return _pad(d["mass"]), [_pad(d[f"stiff_{ax}"]) for ax in range(3)]


def _inverse3d(P, dirichlet, n_fields):
    """[Z, Y, X, F, F] blocks -> ``Minv`` over the 1-tuple of [F, F, Z, Y, X]
    inverse planes, row ``field`` of each ``DirichletBC3D`` row the unit row
    (the residual row is ``u - g``) before the inverse, as in the JAX package
    (``precond.py:198-208``)."""
    for bc in dirichlet:
        row = torch.zeros(n_fields, dtype=P.dtype, device=P.device)
        row[bc.field] = 1.0
        at = [slice(None)] * 3
        at[bc.axis] = bc.index
        P[(*at, bc.field)] = row
    return _apply((small_inv(P).permute(3, 4, 0, 1, 2).contiguous(),))


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
    ``DirichletBC3D`` in ``dirichlet`` are unit rows (``_inverse3d``)."""
    mass_d, stiff_d = _diagonals3d(grid, device, dtype)
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
        return _inverse3d(P, dirichlet, F)

    return build


def make_block_jacobi3d_terms(grid: TetGrid, terms, n_fields: int, *,
                              device: torch.device | str, dirichlet=(),
                              dtype=torch.float64,
                              needs_coords: bool = False):
    """The blocks of ``make_block_jacobi3d`` from ``torch.func.jvp`` of the
    model's ``terms`` with one-hot field tangents, as the JAX package's
    ``make_block_jacobi3d`` builds them by ``jax.jvp`` (``precond.py:
    154-232``): the 3D preconditioner of a benchmark with no hand-written
    tangent (poisson3d, in f64). ``needs_coords`` as in
    ``make_block_jacobi``."""
    mass_d, stiff_d = _diagonals3d(grid, device, dtype)

    def build(w, w0, dt):
        with _lib.timed("jvp_blocks", w[0]):
            (u,) = (a.to(dtype) for a in w)
            (u0,) = (a.to(dtype) for a in w0)
            zer = torch.zeros_like(u)

            def f(uu, *dd):
                return _pointwise_eval(terms, uu, dd, u0, dt, u.shape,
                                       needs_coords)

            cols = []
            for j in range(n_fields):
                e = torch.zeros_like(u)
                e[j] = 1.0
                _, t_u = torch.func.jvp(lambda a: f(a, zer, zer, zer), (u,),
                                        (e,))
                col = t_u[0] * mass_d
                for ax in range(3):
                    def fd(a, ax=ax):
                        dd = [zer, zer, zer]
                        dd[ax] = a
                        return f(u, *dd)

                    _, t_d = torch.func.jvp(fd, (zer,), (e,))
                    col = col + t_d[1 + ax] * stiff_d[ax]
                cols.append(col)
            P = torch.movedim(torch.stack(cols, dim=-1), 0, -2)
            return _inverse3d(P, dirichlet, n_fields)

    return build


def make_identity_precond():
    """``precond='none'``: ``build(w, w0, dt) -> Minv`` with ``Minv(r) =
    r``."""
    def build(w, w0, dt):
        return lambda r: r

    return build


def make_dense_precond(grid: CrossedTriGrid, terms, n_fields: int, *,
                       device: torch.device | str, dirichlet=(),
                       dtype=torch.float64, needs_coords: bool = False,
                       chunk: int = 512, impl: str = "auto"):
    """The inverse of the whole Jacobian, the JAX package's LAPACK form of
    ``make_dense_precond`` (``precond.py:261-313``): for small stiff linear
    systems (elast's 250 x 10 thin-beam cantilever, 10,522 dofs, where no
    smoother-based V-cycle converges in the residual norm).

    ``build(w, w0, dt) -> Minv``: J by columns, ``chunk`` at a time, each
    chunk one ``torch.func.vmap`` of ``torch.func.jvp`` of the flattened
    residual over one-hot tangents (the stored shapes' padding skipped by
    the flatten); the row equilibration ``d = 1 / max_j |J_ij|``; the LU of
    ``diag(d) J`` by ``torch.linalg.lu_factor`` and its explicit inverse
    ``A`` by ``torch.linalg.lu_solve`` against the identity, all in
    ``dtype``; ``Minv(r) = A (d r)``, in ``dtype`` (no cast of ``r`` before
    the scaling). The three parts add to ``_lib.SECONDS`` (``dense_jacobian``,
    ``dense_lu``, ``dense_inverse``). ``impl`` 'auto' and 'lapack' are this
    form; 'mxu' (``mxu_inverse`` and its Newton-Schulz refinement, a
    workaround for the TPU's bf16 LU) is not ported."""
    if impl == "mxu":
        raise NotImplementedError(
            "dense_impl='mxu' (the TPU's mxu_inverse) is not yet ported to "
            "the PyTorch package: 'auto' and 'lapack' factor by LU")
    if impl not in ("auto", "lapack"):
        raise ValueError(f"unknown dense_impl {impl!r}")
    residual = make_residual(grid, terms, n_fields, device=device,
                             dirichlet=dirichlet, needs_coords=needs_coords,
                             dtype=dtype)
    F = n_fields
    ny, nx = grid.ny, grid.nx
    nvy, nvx = grid.n_vertices_y, grid.n_vertices_x
    Yv, Xv = grid.vshape
    Ym, Xm = grid.mshape
    nv = F * nvy * nvx
    n = nv + F * ny * nx

    def flatten(w):
        v, m = w
        return torch.cat([v[:, :nvy, :nvx].reshape(-1),
                          m[:, :ny, :nx].reshape(-1)])

    def unflatten(x):
        return (tF.pad(x[:nv].reshape(F, nvy, nvx), (0, Xv - nvx, 0, Yv - nvy)),
                tF.pad(x[nv:].reshape(F, ny, nx), (0, Xm - nx, 0, Ym - ny)))

    def jacobian(w, w0, dt):
        """J [n, n] of the flattened residual at ``w``."""
        w0 = tr.cast(w0, dtype)
        x0 = flatten(tr.cast(w, dtype))

        def column(t):
            return torch.func.jvp(
                lambda x: flatten(residual(unflatten(x), w0, dt)),
                (x0,), (t,))[1]

        columns = torch.func.vmap(column)
        rows = []
        for start in range(0, n, chunk):
            k = min(chunk, n - start)
            basis = torch.zeros(k, n, dtype=dtype, device=x0.device)
            idx = torch.arange(k, device=x0.device)
            basis[idx, start + idx] = 1.0
            rows.append(columns(basis))     # [k, n]: rows of J^T
        return torch.cat(rows).T

    def build(w, w0, dt):
        with _lib.timed("dense_jacobian", w[0]):
            J = jacobian(w, w0, dt)
        with _lib.timed("dense_lu", w[0]):
            d = 1.0 / torch.clamp(J.abs().amax(dim=1), min=1e-30)
            LU, pivots = torch.linalg.lu_factor(J * d[:, None])
        del J
        with _lib.timed("dense_inverse", w[0]):
            A = torch.linalg.lu_solve(
                LU, pivots, torch.eye(n, dtype=dtype, device=LU.device))
        del LU, pivots

        def Minv(r):
            return unflatten(A @ (d * flatten(r).to(dtype)))

        Minv.inverse = A
        return Minv

    build.jacobian = jacobian
    return build


BUILDERS = {"none": lambda *a, **k: make_identity_precond(),
            "block_jacobi": make_block_jacobi,
            "dense": make_dense_precond}
