"""Explicit-halo assembly over a communicator: the 2D part of
``pfhubbenchmarks_tpu/parallel/halo.py``.

Each shard holds the blocks ``[F, by, bx]`` of the vertex and centre grids
(parallel/mesh.py). ``extend`` grows a block by halo lines pulled from its
mesh neighbours (parallel/comm.py), the PETSc ghostUpdate pattern;
``make_halo_residual`` assembles each shard's cells on its extended block and
pushes the seam contributions back to their owners, and
``make_halo_functional`` sums an integral over the mesh with an explicit
all-reduce.

Layout requirement, as in the JAX package: ``grid.vshape == grid.mshape``,
divisible by the mesh (``aligned_pad_to``), so cell row j lives on the shard
that owns vertex row j. Periodic grids and coordinate-dependent terms are
not supported here. ``make_halo_residual3d`` is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import (QPContext, TabTensors,
                                                    _as_tuples, _context,
                                                    _eval_qp, local_values,
                                                    scatter_add,
                                                    slot_contributions)
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid


def aligned_pad_to(ny: int, nx: int, mesh_shape: tuple[int, int]):
    """pad_to making vshape == mshape and divisible by the mesh
    (``halo.py:48-60``): both stored grids rounded up to the same multiple
    of the mesh shape that fits the (larger) vertex grid."""
    my, mx = mesh_shape

    def up(n, m):
        return -(-n // m) * m

    return (up(ny + 1, my), up(nx + 1, mx))


def extend(blocks, comm, *, lo: int = 1, hi: int = 1) -> list[torch.Tensor]:
    """``[..., by, bx]`` blocks -> ``[..., by+lo+hi, bx+lo+hi]`` with halo
    lines pulled from the mesh neighbours (``halo_smoother.py:66-83``). Rows
    first; then columns of the row-extended arrays, so the corners arrive in
    the second phase. A shard with no neighbour on a side gets zeros."""
    a = list(blocks)
    if lo:
        top = comm.pull_prev([b[..., -lo:, :] for b in a], "y")
        a = [torch.cat([t, b], dim=-2) for t, b in zip(top, a)]
    if hi:
        bot = comm.pull_next([b[..., lo:lo + hi, :] for b in a], "y")
        a = [torch.cat([b, t], dim=-2) for t, b in zip(bot, a)]
    if lo:
        left = comm.pull_prev([b[..., :, -lo:] for b in a], "x")
        a = [torch.cat([t, b], dim=-1) for t, b in zip(left, a)]
    if hi:
        right = comm.pull_next([b[..., :, lo:lo + hi] for b in a], "x")
        a = [torch.cat([b, t], dim=-1) for t, b in zip(right, a)]
    return a


def extend_pairs(shards, comm) -> list[tuple]:
    """``(v, m)`` blocks -> their slabs: the vertex block with a line on each
    side (lo=1, hi=1), the centre block with one below and left (hi=0), the
    operands of a shard's cells and its -1 halo row and column."""
    return list(zip(extend([b[0] for b in shards], comm),
                    extend([b[1] for b in shards], comm, hi=0)))


def _check_layout(grid: CrossedTriGrid, mesh) -> tuple[int, int]:
    if grid.periodic:
        raise NotImplementedError("halo assembly: periodic grids")
    if grid.vshape != grid.mshape:
        raise ValueError(
            "halo assembly needs vertex/cell shard alignment: construct the "
            f"grid with pad_to=aligned_pad_to(...) (got vshape={grid.vshape} "
            f"mshape={grid.mshape})")
    return mesh.block_shape(*grid.vshape)


def block_grid(grid: CrossedTriGrid, ly: int, lx: int) -> CrossedTriGrid:
    """A shard's block as a grid of ly x lx cells of the same spacing."""
    return dataclasses.replace(grid, ny=ly, nx=lx, Ly=grid.hy * ly,
                               Lx=grid.hx * lx, pad_to=(1, 1))


def _cell_valid(grid, mesh, rank, ly, lx, device):
    """The shard's cells inside the logical ny x nx region."""
    iy, ix = mesh.coords(rank)
    ys = iy * ly + torch.arange(ly, device=device)
    xs = ix * lx + torch.arange(lx, device=device)
    return (ys < grid.ny)[:, None] & (xs < grid.nx)[None, :]


def make_halo_residual(
    grid: CrossedTriGrid,
    terms: Callable[[QPContext], tuple[Sequence, Sequence]],
    n_fields: int,
    comm,
    *,
    dirichlet=(),
):
    """``residual(w, w0, dt) -> [(rv, rm), ...]``, one pair per held shard
    (``halo.py:84-210``): the blocks of ``fem/assembly.make_residual``'s
    result, in f64. ``w`` and ``w0`` are lists of ``(v, m)`` blocks in the order of
    ``comm.ranks``. The rows of each ``DirichletBC`` become ``u - g`` on the
    shard that owns the line."""
    del n_fields  # the field count follows from the state
    mesh = comm.mesh
    ly, lx = _check_layout(grid, mesh)
    blk = block_grid(grid, ly, lx)
    T = TabTensors.make(grid, torch.float64, comm.device)
    valid = {r: _cell_valid(grid, mesh, r, ly, lx, comm.device)
             for r in comm.ranks}
    bc_data = []
    for bc in dirichlet:
        g = torch.as_tensor(bc.g, dtype=torch.float64, device=comm.device)
        if bc.side in ("left", "right"):
            shard_i, li = divmod(bc.index, lx)
            bc_data.append(("col", bc.field, shard_i, li, g))
        else:
            shard_i, li = divmod(bc.index, ly)
            bc_data.append(("row", bc.field, shard_i, li, g))

    def residual(w, w0, dt):
        vext = extend([b[0] for b in w], comm, lo=0)
        v0ext = extend([b[0] for b in w0], comm, lo=0)
        rv_ext, rm = [], []
        for i, r in enumerate(comm.ranks):
            ctx = _context(T, blk, (vext[i], w[i][1]), (v0ext[i], w0[i][1]), dt)
            r_loc = torch.where(valid[r], slot_contributions(T, blk, terms(ctx)),
                                0.0)
            ev, em = scatter_add(r_loc, (ly + 1, lx + 1), (ly, lx), ly, lx)
            rv_ext.append(ev)
            rm.append(em)
        # the seam lines go back to their owners, the +1 neighbours, which
        # pull them as their -1 neighbour's lines and add them
        rv = [e[:, :ly, :lx].clone() for e in rv_ext]
        for b, s in zip(rv, comm.pull_prev([e[:, ly:, :lx] for e in rv_ext],
                                           "y")):
            b[:, 0:1, :] += s
        for b, s in zip(rv, comm.pull_prev([e[:, :ly, lx:] for e in rv_ext],
                                           "x")):
            b[:, :, 0:1] += s
        corner = comm.pull_prev(comm.pull_prev([e[:, ly:, lx:] for e in rv_ext],
                                               "y"), "x")
        for b, s in zip(rv, corner):
            b[:, 0:1, 0:1] += s
        # Dirichlet rows: u - g on the owning shard's boundary line
        for i, r in enumerate(comm.ranks):
            iy, ix = mesh.coords(r)
            vb = w[i][0]
            for kind, f, shard_i, li, g in bc_data:
                if kind == "col" and ix == shard_i:
                    rv[i][f, :, li] = vb[f, :, li] - g[iy * ly:(iy + 1) * ly]
                elif kind == "row" and iy == shard_i:
                    rv[i][f, li, :] = vb[f, li, :] - g[ix * lx:(ix + 1) * lx]
        return list(zip(rv, rm))

    return residual


def make_halo_functional(
    grid: CrossedTriGrid,
    density: Callable[[QPContext], torch.Tensor],
    comm,
):
    """``value(w) -> scalar tensor``: an f64 integral functional over the held
    shards' blocks ``w``, summed over the mesh by ``comm.allreduce_sum``
    (``halo.py:213-266``; the allreduce(SUM) of the reference's
    observables)."""
    mesh = comm.mesh
    ly, lx = _check_layout(grid, mesh)
    T = TabTensors.make(grid, torch.float64, comm.device)
    full_shape = (4, T.wq.shape[1], ly, lx)
    valid = {r: _cell_valid(grid, mesh, r, ly, lx, comm.device)
             for r in comm.ranks}

    def value(w):
        vext = extend([b[0] for b in w], comm, lo=0)
        parts = []
        for i, r in enumerate(comm.ranks):
            uq, du = _eval_qp(T.Bq, T.Gs, local_values((vext[i], w[i][1]), ly, lx))
            u_t, du_t = _as_tuples(uq, du)
            ctx = QPContext(u=u_t, du=du_t, u0=None, du0=None, dt=None)
            e = torch.where(valid[r], torch.broadcast_to(density(ctx), full_shape),
                            0.0)
            parts.append(torch.einsum("tq,tqyx->", T.wq, e))
        return comm.allreduce_sum(parts)

    return value
