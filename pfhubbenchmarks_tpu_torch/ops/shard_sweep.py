"""Kernel S (``csrc/shard_sweep.cu`` over ``csrc/shard_sweep.cuh``): the
per-shard body of one sweep of the sharded LMR smoother.

Replaces the ``pallas_call`` of ``pfhubbenchmarks_tpu/parallel/
halo_smoother.py:make_sharded_lmr_sweep`` (:153). On a shard's slab (its
owned by x bx block extended by the halo exchange, parallel/halo.extend;
a grid of (by+1) x (bx+1) cells) it computes ``z = P^-1 r`` and ``A z``, the
J.v of the block's weak form with each cell's contribution times the
logical-cell mask, and returns their owned windows ``[F, by, bx]``.
Instantiated for BM1 (``KernelPhys`` kind "ch") and BM3 ("ach").

The plain version beside it (einsums for ``P^-1 r``, the benchmark's
hand-written tangent assembled in f32 on the slab grid, the mask, the
scatter) serves CPU tensors and the card-side check; the wrapper takes it
for CPU tensors only, and a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import (TabTensors, _context,
                                                    scatter_add,
                                                    slot_contributions)
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import (KernelPhys, params_head,
                                                  with_dt)

SYMBOLS = {"ch": "pfh_shard_sweep_ch", "ach": "pfh_shard_sweep_ach"}


def make_shard_sweep(slab: CrossedTriGrid, phys: KernelPhys, n_fields: int, *,
                     device: torch.device | str):
    """Returns ``s(r, w, w0, pinv, mask, dt) -> (z, Az)`` on one shard's
    slab grid ``slab`` ((by+1) x (bx+1) cells, unpadded): ``r``, ``w``,
    ``w0`` and ``pinv`` are (v, m) pairs of slabs (``[F, by+2, bx+2]`` and
    ``[F, by+1, bx+1]``; ``pinv`` ``[F, F, ., .]``), ``mask`` the cell mask
    ``[by+1, bx+1]``; ``z`` and ``Az`` are pairs of owned windows
    ``[F, by, bx]``. ``s.plain`` and ``s.kernel`` are the two versions."""
    if phys.kind == "acha":
        raise NotImplementedError("kernel S at the anisotropic BM3's physics "
                                  "is not yet ported")
    if phys.kind not in SYMBOLS:
        raise ValueError(f"kernel S has no {phys.kind!r} instantiation")
    if slab.periodic or slab.pad_to != (1, 1):
        raise ValueError("shard_sweep: the slab is an unpadded grid")
    F = n_fields
    by, bx = slab.ny - 1, slab.nx - 1
    T = TabTensors.make(slab, torch.float32, device)
    head = params_head(slab, phys.constants, "shard_sweep")
    nq = slab.tab().nq
    vshape, mshape = (F,) + slab.vshape, (F,) + slab.mshape

    def owned(a):
        return a[:, 1:by + 1, 1:bx + 1]

    def plain(r, w, w0, pinv, mask, dt):
        z = tuple(torch.einsum("ijyx,jyx->iyx", P, rl) for P, rl in zip(pinv, r))
        src_flux = phys.tangent(_context(T, slab, w, w0, dt),
                                _context(T, slab, z, None, None))
        r_loc = slot_contributions(T, slab, src_flux) * mask
        az = scatter_add(r_loc, slab.vshape, slab.mshape, slab.ny, slab.nx)
        return tuple(owned(a) for a in z), tuple(owned(a) for a in az)

    def kernel(r, w, w0, pinv, mask, dt):
        del w0  # the tangents do not read the previous time level
        _lib.check_cuda("shard_sweep", [*r, *w, *pinv, mask])
        for pair in (r, w):
            _lib.check_shapes("shard_sweep", pair, vshape, mshape)
        _lib.check_shapes("shard_sweep", pinv, (F,) + vshape, (F,) + mshape)
        if tuple(mask.shape) != slab.mshape:
            raise ValueError(f"shard_sweep: mask {tuple(mask.shape)}, "
                             f"expected {slab.mshape}")
        out = [torch.empty((F, by, bx), dtype=torch.float32, device=r[0].device)
               for _ in range(4)]
        params = with_dt(head, dt, "shard_sweep")
        _lib.library().call(
            SYMBOLS[phys.kind], params.ctypes.data, nq, pinv[0].data_ptr(),
            pinv[1].data_ptr(), r[0].data_ptr(), r[1].data_ptr(),
            w[0].data_ptr(), w[1].data_ptr(), mask.data_ptr(),
            *(o.data_ptr() for o in out), by, bx, _lib.stream_handle())
        _lib.count_launch("shard_sweep")
        return (out[0], out[1]), (out[2], out[3])

    def s(r, w, w0, pinv, mask, dt):
        return (plain if _lib.on_cpu(r[0]) else kernel)(r, w, w0, pinv, mask, dt)

    s.plain = plain
    s.kernel = kernel
    return s


def cell_mask(grid: CrossedTriGrid) -> np.ndarray:
    """The logical-cell mask on the centre storage: 1 inside [ny, nx), 0 in
    the padding (float32)."""
    m = np.zeros(grid.mshape, np.float32)
    m[: grid.ny, : grid.nx] = 1.0
    return m
