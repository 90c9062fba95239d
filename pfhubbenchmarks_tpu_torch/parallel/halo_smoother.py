"""The sharded LMR smoother: kernel S per shard, halo exchanges and an
all-reduced step length.

Counterpart of ``pfhubbenchmarks_tpu/parallel/halo_smoother.py:
make_sharded_lmr_sweep``. Per call (n sweeps), over a communicator
(parallel/comm.py):

1. pull the sweep-invariant halos once: w, w0, the P^-1 planes and the
   logical-cell mask (an edge shard receives zeros for its missing
   neighbour, which also zeroes the fake halo cells);
2. per sweep: pull r's halo (the 2-phase exchange of parallel/halo.extend),
   run kernel S on each held shard (ops/shard_sweep.py: z = P^-1 r and A z
   over the owned cells and the -1 halo row and column), all-reduce the
   shards' partials of <Az, r> and <Az, Az> (the first stage of kernel C),
   then alpha = num / den (0 when den <= 0) and the two axpys, locally (C's
   second stage).

The step length comes from global sums, so the sharded sweep is the
single-device sweep up to the order of the f32 sums. Layout requirement, as
in the JAX package: ``grid.vshape == grid.mshape``, divisible by the mesh
(parallel/halo.aligned_pad_to).
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import lmr
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import KernelPhys
from pfhubbenchmarks_tpu_torch.ops.shard_sweep import cell_mask, make_shard_sweep
from pfhubbenchmarks_tpu_torch.parallel.halo import (block_grid, extend,
                                                     extend_pairs)
from pfhubbenchmarks_tpu_torch.parallel.mesh import shard_state


def make_sharded_lmr_sweep(grid: CrossedTriGrid, phys: KernelPhys,
                           n_fields: int, comm):
    """Returns ``sweep(x, r, w, w0, pinv, dt, n) -> (x, r)`` over the held
    shards of ``comm`` (its mesh and device are the communicator's): ``x``,
    ``r``, ``w``, ``w0`` are lists of ``(v, m)`` blocks ``[F, by, bx]`` in the
    order of ``comm.ranks``, ``pinv`` a list of ``(pv, pm)`` plane blocks
    ``[F, F, by, bx]`` (solve/precond.py's planes, split by
    parallel/mesh.shard_state). Runs ``n`` sweeps on copies of ``x`` and
    ``r`` and returns them. Kernels S and C are f32, so the sweep casts its
    operands to f32."""
    mesh = comm.mesh
    Yv, Xv = grid.vshape
    if grid.vshape != grid.mshape:
        raise ValueError(
            "sharded fused smoother needs aligned vertex/center storage "
            f"(parallel.halo.aligned_pad_to); got vshape={grid.vshape} "
            f"mshape={grid.mshape}")
    if Yv % mesh.my or Xv % mesh.mx:
        raise ValueError(f"grid {grid.vshape} does not divide over mesh "
                         f"{mesh.shape}")
    by, bx = Yv // mesh.my, Xv // mesh.mx
    s = make_shard_sweep(block_grid(grid, by + 1, bx + 1), phys, n_fields,
                         device=comm.device)
    mask = [b[0] for b in shard_state(
        (torch.as_tensor(cell_mask(grid), dtype=torch.float32,
                          device=comm.device),),
        comm)]

    def sweep(x, r, w, w0, pinv, dt, n: int):
        def cast(shards, copy=False):
            return [tuple(a.to(torch.float32, copy=copy) for a in b)
                    for b in shards]

        x, r = cast(x, copy=True), cast(r, copy=True)
        w, w0, pinv = cast(w), cast(w0), cast(pinv)
        # the sweep-invariant halos, once
        w_e, w0_e, p_e = (extend_pairs(t, comm) for t in (w, w0, pinv))
        mask_e = extend(mask, comm, hi=0)
        for _ in range(n):
            z_az = [s(*a, dt) for a in zip(extend_pairs(r, comm), w_e, w0_e,
                                           p_e, mask_e)]
            total = comm.allreduce_sum([lmr.lmr_partials(az, ri)
                                        for (_, az), ri in zip(z_az, r)])
            for (z, az), xi, ri in zip(z_az, x, r):
                lmr.lmr_update(total, xi, ri, z, az)
        return x, r

    return sweep
