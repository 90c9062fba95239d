"""Geometric multigrid V-cycle preconditioner on the crossed-grid hierarchy.

Counterpart of ``pfhubbenchmarks_tpu/solve/gmg.py`` (``build_hierarchy``,
``make_gmg``) for dyadic hierarchies. The cycle is the one of
``ops/pallas_vcycle.py:make_fused_vcycle``:

- per-level linearization states injected once per build (kernel D), and
  per-level node-block-Jacobi inverses (solve/precond.py);
- local-minimal-residual smoothing: z = P^-1 r (kernel B), A z (kernel A on
  the level's rule), the alpha step and both axpys (kernel C);
- restriction and prolongation with the correction added in place
  (kernel D), and the residual recomputed as b - A x in one kernel-A launch;
- the coarsest level solved by ``coarse_sweeps`` LMR sweeps from zero, or by
  the exact dense inverse when its dof count is at most
  ``dense_coarse_max_dofs`` (plain ``torch.linalg``);
- ``Minv.minv_matvec`` returns the pair (z, A z), with A z the true-rule
  fine-level J.v (kernel A on the fine grid's own rule) that FGMRES
  consumes in place of its outer matvec.

On CUDA tensors every step above except the dense coarse solve is a
hand-written kernel launch; on CPU tensors the same code runs the plain
versions. The W-cycle, GCR ``inner_mr``, field groups, Dirichlet rows and
non-dyadic hierarchies are not yet ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops.lmr import lmr_step
from pfhubbenchmarks_tpu_torch.solve import tree as tr
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi
from pfhubbenchmarks_tpu_torch.solve.transfer import (inject_any, prolong_any,
                                                      restrict_any)

_RATIOS = (2, 3, 5, 7)


def build_hierarchy(grid: CrossedTriGrid, max_levels: int = 10,
                    min_cells: int = 7) -> list[CrossedTriGrid]:
    """Per-axis coarsening by the smallest workable ratio, as in the JAX
    package (only the dyadic pairs have ported transfers)."""
    grids = [grid]
    while len(grids) < max_levels:
        g = grids[-1]
        ratios_try = (2,) if g.periodic else _RATIOS

        def pick(n):
            return next((r for r in ratios_try
                         if n % r == 0 and n // r >= min_cells), 1)

        rx, ry = pick(g.nx), pick(g.ny)
        if rx == 1 and ry == 1:
            break
        if g.periodic and rx != ry:
            break
        grids.append(dataclasses.replace(g, nx=g.nx // rx, ny=g.ny // ry))
    return grids


def coarse_dof_count(g: CrossedTriGrid, n_fields: int) -> int:
    return n_fields * (g.n_vertices_y * g.n_vertices_x + g.ny * g.nx)


def make_dense_coarse(g: CrossedTriGrid, residual_c, n_fields: int):
    """Exact coarsest-level solver: the coarse Jacobian by ``torch.func.
    jacfwd``, row-equilibrated, inverted by ``torch.linalg.inv`` (the JAX
    package's LAPACK branch, gmg.py:89-152)."""
    ny, nx = g.ny, g.nx
    nvy, nvx = g.n_vertices_y, g.n_vertices_x
    F = n_fields
    nv = F * nvy * nvx

    def flatten(w):
        v, m = w
        return torch.cat([v[:, :nvy, :nvx].reshape(-1), m[:, :ny, :nx].reshape(-1)])

    def unflatten(x):   # out-of-place, so torch.func can trace it
        v = x[:nv].reshape(F, nvy, nvx)
        m = x[nv:].reshape(F, ny, nx)
        v = torch.nn.functional.pad(v, (0, g.vshape[1] - nvx, 0, g.vshape[0] - nvy))
        m = torch.nn.functional.pad(m, (0, g.mshape[1] - nx, 0, g.mshape[0] - ny))
        return v, m

    def build_inv(wl, w0l, dtl):
        x0 = flatten(wl)
        J = torch.func.jacfwd(
            lambda x: flatten(residual_c(unflatten(x), w0l, dtl)))(x0)
        d = 1.0 / torch.clamp(J.abs().amax(dim=1), min=1e-30)
        return torch.linalg.inv(J * d[:, None]), d

    def solve(Jinv, b):
        A, d = Jinv
        return unflatten(A @ (d * flatten(b)))

    return build_inv, solve


def make_gmg(grid: CrossedTriGrid, terms, n_fields: int, *,
             device: torch.device | str, jvp_for, nu_pre: int = 2,
             nu_post: int = 2, nu_fine_pre: int = 0, nu_fine_post: int = 0,
             coarse_sweeps: int = 24, max_levels: int = 10,
             precond_rule: str | None = None, min_cells: int = 7,
             dense_coarse_max_dofs: int = 1500, cycle: str = "v",
             inner_mr: int = 1):
    """Returns ``build(w, w0, dt) -> Minv`` applying one f32 V-cycle.

    ``jvp_for(g)`` makes the level J.v ``jv(w, w0, dt, v, b=None)`` on grid
    ``g`` (ops/ch_jvp.make_ch_jvp for BM1). ``Minv(r)`` returns z = M^-1 r
    and ``Minv.minv_matvec(r)`` the pair (z, A z) with the true-rule A.
    """
    if cycle != "v" or inner_mr != 1:
        raise NotImplementedError("only the plain V-cycle is ported")
    nfp = nu_fine_pre or nu_pre
    nfo = nu_fine_post or nu_post
    grids = build_hierarchy(grid, max_levels=max_levels, min_cells=min_cells)
    if precond_rule:
        grids = [dataclasses.replace(g, rule_name=precond_rule) for g in grids]
    L = len(grids)
    jvs = [jvp_for(g) for g in grids]
    mv_jv = jvp_for(grid)   # exported pair: the TRUE-rule fine-level J.v
    bj_builders = [make_block_jacobi(g, terms, n_fields, device=device)
                   for g in grids]
    Ps = [prolong_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    Rs = [restrict_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    injs = [inject_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    dense_coarse = None
    if coarse_dof_count(grids[-1], n_fields) <= dense_coarse_max_dofs:
        residual_c = make_residual(grids[-1], terms, n_fields, device=device,
                                   dtype=torch.float32)
        dense_coarse = make_dense_coarse(grids[-1], residual_c, n_fields)

    def build(w, w0, dt):
        dtf = float(np.float32(dt))
        wl = tr.cast(w, torch.float32)
        w0l = tr.cast(w0, torch.float32)
        states, bjs = [], []
        for l in range(L):
            states.append((wl, w0l))
            bjs.append(bj_builders[l](wl, w0l, dtf))
            if l + 1 < L:
                wl = injs[l](wl)
                w0l = injs[l](w0l)
        Jinv_coarse = (dense_coarse[0](wl, w0l, dtf)
                       if dense_coarse is not None else None)

        def Az(l, z, b=None):
            return jvs[l](states[l][0], states[l][1], dtf, z, b)

        def sweeps(l, x, r, n):
            """n LMR sweeps on (x, r), in place."""
            for _ in range(n):
                z = bjs[l](r)
                lmr_step(x, r, z, Az(l, z))

        def smooth_from_zero(l, b, n):
            x = tr.zeros_like(b)
            r = tuple(t.clone() for t in b)
            sweeps(l, x, r, n)
            return x, r

        def vcycle(l, b):
            if l == L - 1:
                if Jinv_coarse is not None:
                    return dense_coarse[1](Jinv_coarse, b)
                return smooth_from_zero(l, b, coarse_sweeps)[0]
            x, r = smooth_from_zero(l, b, nfp if l == 0 else nu_pre)
            Ps[l](vcycle(l + 1, Rs[l](r)), out=x)   # x += P xc
            r = Az(l, x, b=b)                         # r = b - A x
            sweeps(l, x, r, nfo if l == 0 else nu_post)
            return x

        def Minv(r):
            return vcycle(0, tr.cast(r, torch.float32))

        def minv_matvec(r):
            z = Minv(r)
            return z, mv_jv(states[0][0], states[0][1], dtf, z)

        Minv.minv_matvec = minv_matvec
        return Minv

    return build
