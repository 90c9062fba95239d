"""Geometric multigrid V-cycle preconditioner on the crossed-grid hierarchy.

Counterpart of ``pfhubbenchmarks_tpu/solve/gmg.py`` (``build_hierarchy``,
``make_gmg``) for hierarchies of dyadic and equal odd-ratio pairs (bench3's
350/175/35/7). One V-cycle serves every configuration: the ``split_chain``
cycle of ``gmg.py:654-662``, which does the arithmetic of the
``split_levels`` recursion (:663-675) and of ``ops/pallas_vcycle.py:
make_fused_vcycle`` too. Where the JAX package runs that fused kernel
(``fuse_vcycle`` "auto" and its gate, ``gmg.py:320-345``: bench1, bench2),
``Minv.minv_matvec`` on CUDA tensors is one launch of kernel V
(ops/vcycle_fused.py), the whole cycle below and its exported A z; its plain
version, and ``Minv`` alone, are the split apply:

- per-level linearization states injected once per build and per-level
  node-block-Jacobi inverses: on CUDA tensors one launch of kernel N's
  one-launch form for the whole build (ops/node_blocks.NodeBuildPlan,
  built with the cycle from the levels' ``NodeBlockPlan`` s, each from the
  level's gather J.v), which writes every level's planes and the coarse
  levels' injected states, each coarse node copied from the finest level;
  on CPU tensors its plain version, per level the hand-written tangent with
  one-hot directions (solve/precond.make_block_jacobi_tangent) and the
  chained injections (ops/transfer.TransferPlan: kernel D's plain version
  for a dyadic pair, strided slicing for an odd ratio); the
  ``torch.func.jvp`` build (``make_block_jacobi``) is not on this path;
- ``descend_chain`` (ops/vcycle_chain.py): per level the descend step (TPU
  kernel 6): local-minimal-residual pre-sweeps from zero (per sweep z =
  P^-1 r, A z by the level J.v's body, the alpha step and both axpys: kernel
  L's body) and restriction (kernel D's bodies, or H's for an odd ratio);
- the coarsest level solved by ``coarse_sweeps`` LMR sweeps from zero (one
  launch of L), or by the exact dense inverse when its dof
  count is at most ``dense_coarse_max_dofs`` (the Jacobian by
  ``torch.func.jacfwd`` and ``torch.linalg.inv`` once per build, applied
  by one f32 matmul: bench3's 7^2, 226 dofs);
- ``ascend_chain``: per level the ascend step (TPU kernel 9): prolongation
  with the correction added (D's or H's bodies), the residual recomputed as
  b - A x by the level J.v's body, and the post-sweeps; each chain is one
  launch of its chain kernel (``vcycle_descend_chain``,
  ``vcycle_ascend_chain``) when every level is a gather level, which is so
  on every main path;
- ``Minv.minv_matvec`` returns the pair (z, A z), with A z the true-rule
  fine-level J.v (the fine grid's own rule) that FGMRES consumes in place of
  its outer matvec.

``fuse_vcycle`` routes as in the JAX package: any value but "off",
"split_levels" and "split_chain" takes kernel V wherever ``fused_gate``
holds (CUDA tensors, at least two levels, all gather levels, every pair
dyadic or of an equal odd ratio, no periodic grid, no Dirichlet rows on the
fine level; the JAX package's VMEM gate has no counterpart). There the
coarsest level is solved by the sweeps, never the dense inverse, as in the
JAX package's fused kernel (``gmg.py:303-305``); V's plain version is the
descend chain, the coarsest sweeps from zero, the ascend chain and the
exported J.v. Elsewhere (the other values, bench3, bench6, the tiled
configuration, CPU tensors) the split apply above runs.

Field split (BM2, ``gmg.py:155-179``): ``terms`` is then the split
``terms_precond``, whose Jacobian is block diagonal by ``field_groups``: the
levels' J.v (``jvp_for(g, True)``), their block-Jacobi inverses and the
dense coarse linearize it, the block-Jacobi apply reads only the in-group
planes, and every LMR step takes one step length per group (the JAX
package's ``field_split_alphas=True``; a global step length with groups is
not ported). The exported A z stays the coupled operator
(``jvp_for(grid, False)``) on the true-rule fine grid: the split one there
breaks FGMRES's Arnoldi relation (``gmg.py:514-521``).

Dirichlet rows (``dirichlet_for(grid)``, BM6's phi edges): each level's
J.v has identity rows there, its block-Jacobi blocks unit rows, and the
transfers zero the restricted residual's coarse BC rows and add no
correction on the fine ones (``zero_bc_rows``, ``gmg.py:633-648``). With BC
rows on the fine level ``minv_matvec`` is not exposed, as in the JAX
package (``gmg.py:474-477``).

Tiled configuration (``tiled=True``: ``SolverConfig.use_tiled_sweeps`` and
``tiled_grid_kernels``, ``gmg.py:216-231, 272-291``): a level with no
Dirichlet rows and more than one row block (ops/fem_tile.multi_block, the
JAX package's ``not bcs`` and ``bc_rows < g.ny``) takes the seam-form tile
J.v (T12, ``jvp_for(g, split, "seam")``) and its tiled sweep loop (TS and
C per sweep, ops/lmr.make_level_sweep_loop); every other level keeps the
gather kernels. A chain with a routed level runs as its launch sequence
(``.sequence``: per level L or the tiled loop, D or H, the level J.v), a
choice made once when the chains are built, from the levels' J.v.

On CUDA tensors every step above except the dense coarse inverse (built
and applied) is a hand-written kernel launch;
on CPU tensors the same code runs the plain versions. The W-cycle, GCR
``inner_mr`` and semicoarsened or periodic hierarchies are not yet ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask, make_residual
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_tile import multi_block
from pfhubbenchmarks_tpu_torch.ops.lmr import make_level_sweep_loop
from pfhubbenchmarks_tpu_torch.ops.node_blocks import (NodeBlockPlan,
                                                       NodeBuildPlan)
from pfhubbenchmarks_tpu_torch.ops.transfer import equal_ratio
from pfhubbenchmarks_tpu_torch.ops.vcycle_chain import (make_ascend_chain,
                                                        make_descend_chain,
                                                        one_launch)
from pfhubbenchmarks_tpu_torch.ops.vcycle_fused import make_fused_vcycle
from pfhubbenchmarks_tpu_torch.solve import tree as tr

_RATIOS = (2, 3, 5, 7)


def build_hierarchy(grid: CrossedTriGrid, max_levels: int = 10,
                    min_cells: int = 7) -> list[CrossedTriGrid]:
    """Per-axis coarsening by the smallest workable ratio, as in the JAX
    package (the transfers of unequal per-axis ratios are not ported)."""
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


def make_dense_coarse(residual_c, flatten, unflatten):
    """Exact coarsest-level solver ``(build_inv, solve)`` over the flat dofs
    that ``flatten``/``unflatten`` map a level state to and from: the coarse
    Jacobian by ``torch.func.jacfwd``, row-equilibrated, inverted by
    ``torch.linalg.inv`` (the JAX package's LAPACK branch, gmg.py:89-152 and
    gmg3d.py:143-144). ``unflatten`` must be out-of-place, so torch.func can
    trace it."""

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


def _flat_maps(g: CrossedTriGrid, n_fields: int):
    """``(flatten, unflatten)`` between a crossed-triangle state (v, m) and
    its vertex then centre dofs."""
    ny, nx = g.ny, g.nx
    nvy, nvx = g.n_vertices_y, g.n_vertices_x
    F = n_fields
    nv = F * nvy * nvx

    def flatten(w):
        v, m = w
        return torch.cat([v[:, :nvy, :nvx].reshape(-1), m[:, :ny, :nx].reshape(-1)])

    def unflatten(x):
        v = x[:nv].reshape(F, nvy, nvx)
        m = x[nv:].reshape(F, ny, nx)
        v = torch.nn.functional.pad(v, (0, g.vshape[1] - nvx, 0, g.vshape[0] - nvy))
        m = torch.nn.functional.pad(m, (0, g.mshape[1] - nx, 0, g.mshape[0] - ny))
        return v, m

    return flatten, unflatten


def _fusable(grids) -> bool:
    """Every pair dyadic or of an equal odd ratio (the JAX package's
    ``transfers_fusable``)."""
    for fine, coarse in zip(grids, grids[1:]):
        try:
            equal_ratio(coarse, fine)
        except (ValueError, NotImplementedError):
            return False
    return True


def fused_gate(grids, jvs, level_bcs, fuse_vcycle: str,
               device: torch.device | str) -> bool:
    """Whether the apply with its exported A z runs as kernel V: the JAX
    package's gate for ``make_fused_vcycle`` (``gmg.py:320-345``: not
    "off", "split_levels" or "split_chain"; at least two levels; every pair
    fusable; no periodic grid; the port's problems have no coordinate
    terms) with the exported pair's (no Dirichlet rows on the fine level,
    ``gmg.py:474-477``), on CUDA tensors (the JAX package's ``use_pallas``
    resolves on its backend), with every level a gather level (a tiled level
    runs the tile kernels)."""
    return (fuse_vcycle not in ("off", "split_levels", "split_chain")
            and torch.device(device).type == "cuda" and len(grids) >= 2
            and one_launch(jvs) and not any(g.periodic for g in grids)
            and _fusable(grids) and not level_bcs[0])


def make_gmg(grid: CrossedTriGrid, terms, n_fields: int, *,
             device: torch.device | str, jvp_for, dirichlet_for=None,
             nu_pre: int = 2, nu_post: int = 2, nu_fine_pre: int = 0,
             nu_fine_post: int = 0, coarse_sweeps: int = 24,
             max_levels: int = 10, precond_rule: str | None = None,
             min_cells: int = 7, dense_coarse_max_dofs: int = 1500,
             cycle: str = "v", inner_mr: int = 1, field_groups=None,
             tiled: bool = False, mv_form: str = "gather",
             fuse_vcycle: str = "auto"):
    """Returns ``build(w, w0, dt) -> Minv`` applying one f32 V-cycle.

    ``jvp_for(g, split, form="gather")`` makes the J.v ``jv(w, w0, dt, v,
    b=None)`` on grid ``g`` with the identity rows of ``dirichlet_for(g)``
    (ops/ch_jvp for BM1, ops/chp_jvp for BM6, ops/chac_jvp for BM2,
    ops/ach_jvp for BM3): of the field-split operator (the linearization of
    ``terms``) for the levels when ``field_groups`` are given, else of the
    coupled one; ``form`` "seam" is the tile kernel T12 that ``tiled``
    routes a level to. ``Minv(r)`` returns z = M^-1 r and
    ``Minv.minv_matvec(r)``, where exposed, the pair (z, A z) with the
    coupled true-rule A, by the J.v of form ``mv_form`` ("box": kernel W,
    bench2 and bench3). ``build.grids`` is the hierarchy,
    ``build.vcycle`` kernel V's cycle (ops/vcycle_fused.make_fused_vcycle)
    where ``fused_gate`` holds (else None), ``build.dense_coarse`` says
    whether the coarsest level is solved by the dense inverse (else by
    ``coarse_sweeps`` LMR sweeps),
    ``build.tiled_levels`` which levels are routed to the tile kernels and
    ``build.node_blocks`` the levels' kernel-N plans and
    ``build.node_build`` the one-launch build over them. Each build adds its
    seconds to ``_lib.SECONDS['precond_build']``, and those of the dense
    inverse within it to ``_lib.SECONDS['dense_coarse']``. ``terms`` is the
    weak form the levels linearize (the dense coarse residual's, and the
    plans' library build's); the blocks come from each level J.v's
    hand-written tangent.
    """
    if cycle != "v" or inner_mr != 1:
        raise NotImplementedError("only the plain V-cycle is ported")
    nfp = nu_fine_pre or nu_pre
    nfo = nu_fine_post or nu_post
    split = field_groups is not None
    grids = build_hierarchy(grid, max_levels=max_levels, min_cells=min_cells)
    if precond_rule:
        grids = [dataclasses.replace(g, rule_name=precond_rule) for g in grids]
    L = len(grids)
    dirichlet_for = dirichlet_for or (lambda g: ())
    level_bcs = [dirichlet_for(g) for g in grids]
    masks = []
    for g, bcs in zip(grids, level_bcs):
        m = bc_mask(g, bcs, n_fields)
        masks.append(None if m is None else torch.as_tensor(m, device=device))
    jvs = [jvp_for(g, split, "seam") if tiled and not bcs and multi_block(g)
           else jvp_for(g, split) for g, bcs in zip(grids, level_bcs)]
    # exported pair: the TRUE-rule fine-level J.v of the coupled operator
    mv_jv = (jvp_for(grid, False) if mv_form == "gather"
             else jvp_for(grid, False, mv_form))
    # kernel N's plan per level, from the level's gather J.v (a tiled
    # level's T12 J.v carries no gather launch record)
    nb_plans = [NodeBlockPlan(
        g, jv if hasattr(jv, "launch") else jvp_for(g, split), terms,
        device=device, dirichlet=bcs)
        for g, jv, bcs in zip(grids, jvs, level_bcs)]
    node_build = NodeBuildPlan(grids, nb_plans, device=device)
    fused = fused_gate(grids, jvs, level_bcs, fuse_vcycle, device)
    dense_coarse = None
    if (not fused
            and coarse_dof_count(grids[-1], n_fields) <= dense_coarse_max_dofs):
        residual_c = make_residual(grids[-1], terms, n_fields, device=device,
                                   dirichlet=level_bcs[-1],
                                   dtype=torch.float32)
        dense_coarse = make_dense_coarse(residual_c,
                                         *_flat_maps(grids[-1], n_fields))
    vcycle = chain = None
    if fused:
        vcycle = make_fused_vcycle(grids, jvs, mv_jv, nu_pre=nu_pre,
                                   nu_post=nu_post, nu_fine_pre=nfp,
                                   nu_fine_post=nfo,
                                   coarse_sweeps=coarse_sweeps,
                                   field_groups=field_groups)
        coarse_sweep = vcycle.coarse
        chain = (vcycle.descend, vcycle.ascend)
    else:
        coarse_sweep = make_level_sweep_loop(jvs[-1], coarse_sweeps,
                                             field_groups)
        if L >= 2:
            chain = (make_descend_chain(grids, jvs, nu=nu_pre, nu_fine=nfp,
                                        masks=masks, field_groups=field_groups),
                     make_ascend_chain(grids, jvs, nu=nu_post, nu_fine=nfo,
                                       masks=masks, field_groups=field_groups))

    def build(w, w0, dt):
        dtf = float(np.float32(dt))
        with _lib.timed("precond_build", w[0]):
            states, planes = node_build(tr.cast(w, torch.float32),
                                        tr.cast(w0, torch.float32), dtf)
            wl, w0l = states[-1]
            Jinv_coarse = None
            if dense_coarse is not None:
                with _lib.timed("dense_coarse", wl[0]):
                    Jinv_coarse = dense_coarse[0](wl, w0l, dtf)

        # the chains' per-level inputs: levels 0..L-2
        chain_states = ([st[0] for st in states[:-1]],
                        [st[1] for st in states[:-1]])
        pinvs = planes[:-1]

        def coarse_solve(b):
            if Jinv_coarse is not None:
                return dense_coarse[1](Jinv_coarse, b)
            x = tr.zeros_like(b)
            r = tuple(t.clone() for t in b)
            return coarse_sweep(x, r, wl, w0l, dtf, *planes[-1])[0]

        def Minv(r):
            b = tr.cast(r, torch.float32)
            if chain is None:
                return coarse_solve(b)
            xs, bs, bc = chain[0](b, *chain_states, dtf, pinvs)
            return chain[1]([b] + bs, xs, coarse_solve(bc), *chain_states,
                            dtf, pinvs)

        def minv_matvec(r):
            if vcycle is not None:
                return vcycle(tr.cast(r, torch.float32),
                              [st[0] for st in states],
                              [st[1] for st in states], dtf, planes)
            z = Minv(r)
            return z, mv_jv(states[0][0], states[0][1], dtf, z)

        if not level_bcs[0]:
            Minv.minv_matvec = minv_matvec
        return Minv

    build.grids = grids
    build.vcycle = vcycle
    build.dense_coarse = dense_coarse is not None
    build.tiled_levels = [hasattr(jv, "tile_sweep") for jv in jvs]
    build.node_blocks = nb_plans
    build.node_build = node_build
    return build
