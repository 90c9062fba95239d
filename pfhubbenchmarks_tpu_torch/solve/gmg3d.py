"""Geometric multigrid cycle for 3D Kuhn-tet grids, with the K-cycle.

Counterpart of ``pfhubbenchmarks_tpu/solve/gmg3d.py`` (``build_hierarchy3d``,
``make_gmg3d``): LMR smoothing on the block-Jacobi preconditioned operator,
coarse rediscretization at the injected state, f32 throughout, over the
single-vertex-grid 3D hierarchy (bench1_3d: 50^3 -> 25^3 -> 5^3, ratios 2
and 5).

- Per build: per-level linearization states injected from the fine one,
  per-level block-Jacobi inverses (solve/precond.make_block_jacobi3d), and
  on a coarsest level of at most ``dense_coarse_max_dofs`` dofs (1500, the
  JAX package's fixed 3D cap, ``gmg3d.py:127``) the exact dense inverse (the
  Jacobian by ``torch.func.jacfwd`` of the f32 residual, rows equilibrated,
  ``torch.linalg.inv``: the JAX package's CPU branch, ``gmg3d.py:143-144``).
- Smoothing: the sweep loop of ops/lmr.py (one launch of kernel L over
  kernel U's box body), which stands for the TPU sweep kernels
  ``make_pallas_lmr_sweep_loop3d`` and ``make_tiled_lmr_sweep3d``.
- ``vcycle(l, b)``: pre-sweeps from zero, restriction, the coarse visit,
  prolongation of its correction, the residual ``b - A x`` in one J.v
  launch, post-sweeps. The coarsest level is the dense solve, or
  ``coarse_sweeps`` LMR sweeps.
- The K-cycle (``kcycle > 1``): every visit of a level below the finest
  that is not the coarsest is ``mr_accel``, ``kcycle`` GCR-combined
  recursive cycles with their ``A z`` directions kept orthogonal.

Face Dirichlet rows (``dirichlet_for(grid)``, bench6_3d's phi faces, JAX
``gmg3d.py:227-240``): every level is rediscretized with its own faces
(``level_bcs``): the level J.v's rows there are identity rows (kernels U
and L's mask), the block-Jacobi rows unit rows, and the dense coarse
Jacobian's rows those of ``u - g``; the residual restricted to a coarse
level and the correction prolonged to a fine one are zeroed on the
constraint rows (``zero_bc_rows3d``), which otherwise carry the PDE
residual.

The transfers are plain torch (solve/transfer3d.py), as in the JAX package
(XLA, outside Pallas). ``Minv`` exports no ``(z, A z)`` pair, so FGMRES calls
its outer J.v every iteration, as in the JAX package. The W-cycle and the
``inner_mr`` wrapper of the finest cycle are not yet ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly3d import (make_residual3d,
                                                      zero_bc_rows3d)
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.lmr import make_lmr_sweep_loop
from pfhubbenchmarks_tpu_torch.solve import tree as tr
from pfhubbenchmarks_tpu_torch.solve.gmg import make_dense_coarse
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi3d
from pfhubbenchmarks_tpu_torch.solve.transfer3d import (inject3d_any,
                                                        prolong3d_any,
                                                        restrict3d_any)


def build_hierarchy3d(grid: TetGrid, max_levels: int = 10,
                      min_cells: int = 4) -> list[TetGrid]:
    """Uniform coarsening by the first of the ratios 2, 3, 5 that divides
    every axis and leaves at least ``min_cells`` cells: Kuhn-P1 spaces nest
    under any integer ratio (solve/transfer3d.py), so 50^3 coarsens to
    25^3 and 5^3."""
    grids = [grid]
    while len(grids) < max_levels:
        g = grids[-1]
        r = next((r for r in (2, 3, 5)
                  if all(n % r == 0 and n // r >= min_cells
                         for n in (g.nx, g.ny, g.nz))), None)
        if r is None:
            break
        grids.append(dataclasses.replace(g, nx=g.nx // r, ny=g.ny // r,
                                         nz=g.nz // r))
    return grids


def coarse_dof_count(g: TetGrid, n_fields: int) -> int:
    return n_fields * g.n_vertices


def _flat_maps(g: TetGrid, n_fields: int):
    """``(flatten, unflatten)`` between a state (v,) and the dofs of its
    one vertex grid (the JAX package's ``_flat``/``_unflat``)."""
    nz, ny, nx = g.nz, g.ny, g.nx
    Z, Y, X = g.vshape

    def flatten(w):
        return w[0][:, : nz + 1, : ny + 1, : nx + 1].reshape(-1)

    def unflatten(x):
        v = x.reshape(n_fields, nz + 1, ny + 1, nx + 1)
        return (torch.nn.functional.pad(
            v, (0, X - nx - 1, 0, Y - ny - 1, 0, Z - nz - 1)),)

    return flatten, unflatten


def make_gmg3d(grid: TetGrid, terms, n_fields: int, *,
               device: torch.device | str, jvp_for, tangent, dirichlet_for=None,
               nu_pre: int = 2, nu_post: int = 2, nu_fine_pre: int = 0,
               nu_fine_post: int = 0, coarse_sweeps: int = 24,
               max_levels: int = 10, precond_rule: str | None = None,
               cycle: str = "v", inner_mr: int = 1, kcycle: int = 1,
               dense_coarse_max_dofs: int = 1500):
    """Returns ``build(w, w0, dt) -> Minv`` applying one f32 cycle.

    ``jvp_for(g)`` makes the level J.v ``jv(w, w0, dt, v, b=None)`` on grid
    ``g`` (kernel U, ops/fem_jvp3d.py) with the identity rows of
    ``dirichlet_for(g)`` (the level's ``DirichletBC3D`` faces, none by
    default); ``tangent`` is the benchmark's
    hand-written pointwise tangent (the block-Jacobi build); ``terms`` its
    weak form (the dense coarse Jacobian). ``precond_rule`` rediscretizes the
    whole hierarchy at a cheaper tet rule (bench1_3d: keast2). ``build.grids``
    is the hierarchy and ``build.dense_coarse`` says whether the coarsest
    level is the dense inverse. Each build adds its seconds to
    ``_lib.SECONDS['precond_build']``."""
    if cycle != "v" or inner_mr != 1:
        raise NotImplementedError("only the 3D V-cycle and K-cycle are ported")
    grids = build_hierarchy3d(grid, max_levels=max_levels)
    if precond_rule:
        grids = [dataclasses.replace(g, rule_name=precond_rule) for g in grids]
    L = len(grids)
    dirichlet_for = dirichlet_for or (lambda g: ())
    level_bcs = [dirichlet_for(g) for g in grids]
    jvs = [jvp_for(g) for g in grids]
    bj_builders = [make_block_jacobi3d(g, tangent, n_fields, device=device,
                                       dirichlet=bcs)
                   for g, bcs in zip(grids, level_bcs)]
    Ps = [prolong3d_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    Rs = [restrict3d_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    injs = [inject3d_any(grids[l + 1], grids[l]) for l in range(L - 1)]
    dense_coarse = None
    if coarse_dof_count(grids[-1], n_fields) <= dense_coarse_max_dofs:
        residual_c = make_residual3d(grids[-1], terms, n_fields, device=device,
                                     dirichlet=level_bcs[-1],
                                     dtype=torch.float32)
        dense_coarse = make_dense_coarse(residual_c,
                                         *_flat_maps(grids[-1], n_fields))
    sweep_counts = {nu_pre, nu_post, nu_fine_pre or nu_pre,
                    nu_fine_post or nu_post, coarse_sweeps}
    sweeps = [{n: make_lmr_sweep_loop(jv, n) for n in sweep_counts}
              for jv in jvs]

    def build(w, w0, dt):
        dtf = float(np.float32(dt))
        with _lib.timed("precond_build", w[0]):
            wl = tr.cast(w, torch.float32)
            w0l = tr.cast(w0, torch.float32)
            states, pinvs = [], []
            for l in range(L):
                states.append((wl, w0l))
                pinvs.append(bj_builders[l](wl, w0l, dtf).pinv_planes)
                if l + 1 < L:
                    wl = injs[l](wl)
                    w0l = injs[l](w0l)
            Jinv_coarse = (dense_coarse[0](wl, w0l, dtf)
                           if dense_coarse is not None else None)

        def jvp(l, v, b=None):
            return jvs[l](*states[l], dtf, v, b)

        def smooth(l, x, r, n):
            """n LMR sweeps on (x, r) in place."""
            return sweeps[l][n](x, r, *states[l], dtf, *pinvs[l])

        def mr_accel(l, b, fn, steps):
            """``steps`` GCR-combined applications of ``fn`` at level l (the
            A z directions kept orthogonal: GMRES(steps) preconditioned by
            ``fn``): the K-cycle's coarse visit."""
            z_acc = tr.zeros_like(b)
            rc = b
            zs, azs = [], []
            for _ in range(steps):
                z = fn(rc)
                az = jvp(l, z)
                for zi, azi in zip(zs, azs):
                    h = tr.vdot(azi, az)
                    az = tr.axpy(-h, azi, az)
                    z = tr.axpy(-h, zi, z)
                nrm_inv = tr.safe_inv(tr.norm(az))
                z = tr.scale(nrm_inv, z)
                az = tr.scale(nrm_inv, az)
                zs.append(z)
                azs.append(az)
                alpha = tr.vdot(az, rc)
                z_acc = tr.axpy(alpha, z, z_acc)
                rc = tr.axpy(-alpha, az, rc)
            return z_acc

        def coarse_visit(l, b):
            if kcycle <= 1 or l == L - 1:
                return vcycle(l, b)
            return mr_accel(l, b, lambda rr: vcycle(l, rr), kcycle)

        def vcycle(l, b):
            if l == L - 1:
                if Jinv_coarse is not None:
                    return dense_coarse[1](Jinv_coarse, b)
                x = tr.zeros_like(b)
                return smooth(l, x, tuple(t.clone() for t in b),
                              coarse_sweeps)[0]
            x = tr.zeros_like(b)
            r = tuple(t.clone() for t in b)
            smooth(l, x, r, (nu_fine_pre or nu_pre) if l == 0 else nu_pre)
            rc = zero_bc_rows3d(Rs[l](r), level_bcs[l + 1])
            x = tr.add(x, zero_bc_rows3d(Ps[l](coarse_visit(l + 1, rc)),
                                         level_bcs[l]))
            r = jvp(l, x, b)
            smooth(l, x, r, (nu_fine_post or nu_post) if l == 0 else nu_post)
            return x

        def Minv(r):
            return vcycle(0, tr.cast(r, torch.float32))

        return Minv

    build.grids = grids
    build.dense_coarse = dense_coarse is not None
    return build
