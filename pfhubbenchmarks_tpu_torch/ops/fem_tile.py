"""Kernels T and TS (``csrc/fem_tile.cuh``): the J.v and the LMR sweep's
(z, A z) over shared-memory tiles, the port's form of the JAX package's
tiled configuration (``SolverConfig.use_tiled_sweeps`` and
``tiled_grid_kernels``).

- ``make_tile_jvp(..., form="recompute")`` (T10) replaces
  ``pfhubbenchmarks_tpu/ops/pallas_tiled.py:make_tiled_jvp``: every block
  re-evaluates the halo cells its owned nodes need and writes only those.
- ``make_tile_jvp(..., form="seam")`` (T12) replaces
  ``ops/pallas_tiled_grid.py:make_grid_tiled_jvp``: every block evaluates
  its own cells only and its seam rows are add-folded. Its ``.tile_sweep``
  (TS) replaces ``make_grid_tiled_lmr_sweep``'s kernel: z = P^-1 r by
  block-Jacobi (the in-group planes of the field groups), then A z in the
  seam form; the step length and the axpys come after it (kernel C, in the
  tiled sweep loop of ops/lmr.py), as the JAX package forms alpha outside
  its kernel.

Both return ``jv(w, w0, dt, v, b=None)`` (``J v``, or ``b - J v``), and
``ts(w, w0, dt, r, pinv, groups=None) -> (z, A z)``, with ``.plain`` and
``.kernel``. The plain versions are in torch and in the TPU kernels' tile
form, row blocks of ``choose_block_rows(ny)`` rows: T10 assembles the
tangent (fem/assembly.make_tangent_jvp, the benchmark's hand-written
``tangent``) on each block's slab with its halo cell rows and keeps the
owned rows; T12 on each block's own cells, then adds the partial seam rows
into the next block's first row. The CUDA kernels tile both axes
(csrc/fem_tile.cuh): they compute the same function with another tile, and
``chip_smoke.py`` holds them against these versions. A wrapper takes the
plain version for CPU tensors only; a CUDA tensor launches the kernel.

``multi_block(grid)`` is the routing rule of the tiled configuration: a
grid with more than one row block (the JAX package's ``bc_rows < g.ny``,
where whole-array kernels give way to tiled ones past VMEM, which the card
does not have).
"""

from __future__ import annotations

import dataclasses

import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask, make_tangent_jvp
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import params_head, with_dt

# csrc/fem_tile.cuh: TileForm, and the launch counter of each form
FORMS = {"recompute": 0, "seam": 1, "sweep": 2}
NAMES = {"recompute": "tile_jvp_recompute", "seam": "tile_jvp_seam",
         "sweep": "tile_sweep"}


def choose_block_rows(ny: int, target: int = 32) -> int | None:
    """Largest divisor of ny that is <= target, at least 4 (None if only
    trivial): the port's copy of ``pfhubbenchmarks_tpu/ops/pallas_tiled.py:
    choose_block_rows``."""
    for bc in range(min(target, ny), 3, -1):
        if ny % bc == 0:
            return bc
    return None


def multi_block(grid: CrossedTriGrid) -> bool:
    """Whether the tiled configuration takes ``grid``: more than one row
    block."""
    bc = choose_block_rows(grid.ny)
    return bc is not None and bc < grid.ny


def _rows(pair, lo: int, hi: int):
    """The slab of cell rows [lo, hi): vertex rows lo..hi, centre rows
    lo..hi-1 (None stays None)."""
    return None if pair is None else (pair[0][:, lo: hi + 1], pair[1][:, lo: hi])


def _slab_jv(grid, tangent, device):
    """``jv(rows, w, w0, dt, v)`` on a slab of ``rows`` cell rows, one
    assembly per slab height."""
    cache = {}

    def jv(rows, *args):
        if rows not in cache:
            slab = dataclasses.replace(grid, ny=rows, Ly=grid.hy * rows)
            cache[rows] = make_tangent_jvp(slab, tangent, device=device,
                                           dtype=torch.float32)
        return cache[rows](*args)

    return jv


def recompute_plain(grid, tangent, device, block_rows=None, mask=None):
    """T10's plain version: per row block, the J.v of its slab with one
    halo cell row on each side (as the JAX kernel evaluates), its owned
    rows kept; then the Dirichlet rows (``mask``) set to v."""
    ny = grid.ny
    bc = block_rows or choose_block_rows(ny)
    nb = ny // bc
    slab_jv = _slab_jv(grid, tangent, device)

    def jv(w, w0, dt, v, b=None):
        out_v, out_m = [], []
        for blk in range(nb):
            lo, hi = max(0, blk * bc - 1), min(ny, (blk + 1) * bc + 1)
            av, am = slab_jv(hi - lo, _rows(w, lo, hi), _rows(w0, lo, hi), dt,
                             _rows(v, lo, hi))
            y0 = blk * bc - lo
            out_v.append(av[:, y0: y0 + bc + (blk == nb - 1)])
            out_m.append(am[:, y0: y0 + bc])
        out = (torch.cat(out_v, 1), torch.cat(out_m, 1))
        if mask is not None:
            out = (torch.where(mask != 0, v[0], out[0]), out[1])
        return out if b is None else (b[0] - out[0], b[1] - out[1])

    return jv


def seam_plain(grid, tangent, device, block_rows=None):
    """T12's plain version: per row block, the J.v of its own cell rows; its
    top vertex row added into the next block's first row (the fold)."""
    ny = grid.ny
    bc = block_rows or choose_block_rows(ny)
    slab_jv = _slab_jv(grid, tangent, device)

    def jv(w, w0, dt, v, b=None):
        out_v = v[0].new_zeros(v[0].shape)
        out_m = []
        for lo in range(0, ny, bc):
            av, am = slab_jv(bc, _rows(w, lo, lo + bc), _rows(w0, lo, lo + bc),
                             dt, _rows(v, lo, lo + bc))
            out_v[:, lo: lo + bc + 1] += av
            out_m.append(am)
        out = (out_v, torch.cat(out_m, 1))
        return out if b is None else (b[0] - out[0], b[1] - out[1])

    return jv


def make_tile_jvp(grid: CrossedTriGrid, tangent, n_fields: int, *, form: str,
                  symbol: str, constants: tuple[float, ...],
                  device: torch.device | str, dirichlet=(), variant=(),
                  block_rows: int | None = None):
    """``form``: "recompute" (T10, with the identity rows of ``dirichlet``)
    or "seam" (T12, no Dirichlet rows; it also builds ``jv.tile_sweep``,
    TS). ``tangent``, ``symbol`` (the physics' tile launcher), ``constants``
    and ``variant`` as for ops/fem_jvp.make_fem_jvp; ``block_rows`` the
    plain version's row block (default ``choose_block_rows(ny)``)."""
    if grid.periodic or grid.pad_to != (1, 1):
        raise NotImplementedError("the tile kernels take unpadded, "
                                  "non-periodic grids")
    if (block_rows or choose_block_rows(grid.ny)) is None:
        raise ValueError(f"no row block divides ny = {grid.ny}")
    if form == "seam" and dirichlet:
        raise ValueError("the seam form takes no Dirichlet rows")
    name = NAMES[form]
    F = n_fields
    head = params_head(grid, constants, name)
    nq = grid.tab().nq
    vshape, mshape = (F,) + grid.vshape, (F,) + grid.mshape
    mask_np = bc_mask(grid, dirichlet, F)
    mask = None if mask_np is None else torch.as_tensor(mask_np, device=device)
    if form == "recompute":
        plain = recompute_plain(grid, tangent, device, block_rows, mask)
    else:
        plain = seam_plain(grid, tangent, device, block_rows)

    def launch(form_, w, dt, t, pinv, b, out, z, groups):
        """One call of the physics' tile launcher; ``t`` is v, or r for TS."""
        lib = _lib.library()
        seam = None
        if form_ != "recompute":
            seam = torch.empty(lib.lib.pfh_tile_seam_floats(F, grid.ny, grid.nx),
                               dtype=torch.float32, device=t[0].device)
        n_groups, starts = lmr.c_groups(lmr.group_starts(groups))

        def ptr(x):
            return None if x is None else x.data_ptr()

        pv, pm = pinv or (None, None)
        bv, bm = b or (None, None)
        zv, zm = z or (None, None)
        params = with_dt(head, dt, name)   # alive until the launch returns
        lib.call(symbol, FORMS[form_], params.ctypes.data, nq, *variant,
                 ptr(w[0]), ptr(w[1]), ptr(t[0]), ptr(t[1]), ptr(pv), ptr(pm),
                 ptr(bv), ptr(bm), ptr(mask), ptr(out[0]), ptr(out[1]),
                 ptr(zv), ptr(zm), ptr(seam), n_groups, starts, grid.ny,
                 grid.nx, _lib.stream_handle())
        _lib.count_launch(NAMES[form_])

    def kernel(w, w0, dt, v, b=None):
        del w0  # the tangents do not read the previous time level
        _lib.check_cuda(name, [*w, *v] + ([*b] if b is not None else [])
                        + ([mask] if mask is not None else []))
        for pair in (w, v) if b is None else (w, v, b):
            _lib.check_shapes(name, pair, vshape, mshape)
        out = (torch.empty_like(v[0]), torch.empty_like(v[1]))
        launch(form, w, dt, v, None, b, out, None, None)
        return out

    def jv(w, w0, dt, v, b=None):
        return (plain if _lib.on_cpu(v[0]) else kernel)(w, w0, dt, v, b)

    jv.plain, jv.kernel, jv.n_fields = plain, kernel, F
    if form == "seam":
        jv.tile_sweep = _make_sweep(plain, launch, vshape, mshape, F)
    return jv


def _make_sweep(seam_jv, launch, vshape, mshape, F):
    """TS: ``ts(w, w0, dt, r, pinv, groups=None) -> (z, A z)``."""
    name = NAMES["sweep"]

    def plain(w, w0, dt, r, pinv, groups=None):
        z = lmr.block_jacobi_apply_plain(pinv, r, groups)
        return z, seam_jv(w, w0, dt, z)

    def kernel(w, w0, dt, r, pinv, groups=None):
        del w0
        _lib.check_cuda(name, [*w, *r, *pinv])
        for pair in (w, r):
            _lib.check_shapes(name, pair, vshape, mshape)
        if any(P.shape != (F, F) + rl.shape[1:] for P, rl in zip(pinv, r)):
            raise ValueError(f"{name}: block planes "
                             f"{[tuple(P.shape) for P in pinv]}")
        z = (torch.empty_like(r[0]), torch.empty_like(r[1]))
        az = (torch.empty_like(r[0]), torch.empty_like(r[1]))
        launch("sweep", w, dt, r, pinv, None, az, z, groups)
        return z, az

    def ts(w, w0, dt, r, pinv, groups=None):
        return (plain if _lib.on_cpu(r[0]) else kernel)(w, w0, dt, r, pinv,
                                                         groups)

    ts.plain, ts.kernel = plain, kernel
    return ts
