"""The gather-form J.v kernels (``csrc/fem_jvp.cuh``): the Python side that
kernels A (ops/ch_jvp.py), E (ops/chp_jvp.py) and F (ops/chac_jvp.py)
share.

``make_fem_jvp`` returns ``jv(w, w0, dt, v, b=None)``: ``J(w, w0, dt) v``,
or ``b - J v`` when ``b`` is given, as an f32 pair. The Dirichlet rows of
``dirichlet`` are identity rows: there the result is ``v`` (or ``b - v``).
One kernel serves every quadrature rule of at most 4 points: the
tabulation of the grid (ffc3 for the outer matvec, dunavant2 or dunavant1 on
the multigrid levels), the physics constants and ``dt`` are launch
arguments.

The plain version beside it is the benchmark's hand-written pointwise
``tangent`` (which the kernel's ``Phys::tangent`` mirrors) assembled in f32
by the residual's einsums with the same BC rows
(fem/assembly.make_tangent_jvp): the function ``torch.func.jvp`` of the
residual computes, without forward AD, whose per-op overhead makes a
6-field J.v ~50 ms on a CPU at any size. The tests hold each tangent
against ``torch.func.jvp``. The wrapper takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import bc_mask, make_tangent_jvp
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib

MAX_Q = 4
MAX_CONST = 12


@dataclasses.dataclass(frozen=True)
class KernelPhys:
    """A benchmark's physics as the gather kernels outside its own J.v
    take it (kernel S, ops/shard_sweep.py; kernel Q, ops/gridjvp.py):
    ``kind`` the instantiation ("ch" BM1, "ach" BM3, "acha" the anisotropic
    BM3, which S and Q refuse), ``tangent`` the
    hand-written pointwise tangent (the plain version; ``Phys::tangent``
    mirrors it), ``constants`` the physics constants in the kernel's order
    (ops/ch_jvp.CONSTANTS, ops/ach_jvp.CONSTANTS)."""

    kind: str
    tangent: Callable
    constants: tuple[float, ...]


@dataclasses.dataclass(frozen=True)
class GatherLaunch:
    """What a gather J.v's launcher receives besides its operands and dt,
    as ``jv.launch`` carries it to kernel L (ops/lmr.py), which runs the
    same body: ``kind`` the physics ("ch", "chp", "chac", "ach", "acha";
    "ch3d" in 3D), ``head`` the parameter block without dt (tabulation, then the
    constants), ``nq`` the rule's point count, ``variant`` the int arguments
    after it (kernel F's field count and operator), ``mask`` the Dirichlet
    vertex mask or None, ``dims`` the grid's cells ((ny, nx) or (nz, ny,
    nx)), ``n_fields`` F."""

    kind: str
    head: np.ndarray
    nq: int
    variant: tuple[int, ...]
    mask: torch.Tensor | None
    dims: tuple[int, ...]
    n_fields: int


def pack_tabulation(grid: CrossedTriGrid) -> np.ndarray:
    """Bq, Gs, WB, WGx, WGy as the kernel's float32 parameter block
    (quadrature axis zero-padded to 4 points)."""
    tab = grid.tab()
    nq = tab.nq
    if nq > MAX_Q:
        raise ValueError(f"the J.v kernels take at most {MAX_Q} points, rule "
                         f"has {nq}")

    def padq(a):  # [4, nq, 5] -> [4, 4, 5]
        out = np.zeros((4, MAX_Q, 5))
        out[:, :nq] = a
        return out

    WB = tab.wq[:, :, None] * tab.Bq
    WGx = tab.wq[:, :, None] * tab.Gs[:, None, :, 0]
    WGy = tab.wq[:, :, None] * tab.Gs[:, None, :, 1]
    parts = [padq(tab.Bq), tab.Gs, padq(WB), padq(WGx), padq(WGy)]
    return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def params_head(grid: CrossedTriGrid, constants: tuple[float, ...],
                name: str) -> np.ndarray:
    """The kernels' JvpParams block (csrc/fem_params.cuh) without its last
    float, dt: the tabulation, then the physics constants padded to
    MAX_CONST. Shared by the gather J.v, the tile kernels (ops/fem_tile.py)
    and the residual (ops/fem_residual.py)."""
    if len(constants) > MAX_CONST:
        raise ValueError(f"{name}: at most {MAX_CONST} constants")
    const = np.zeros(MAX_CONST, np.float32)
    const[: len(constants)] = constants
    return np.concatenate([pack_tabulation(grid), const])


def with_dt(head: np.ndarray, dt: float, name: str) -> np.ndarray:
    """The whole parameter block, checked against the kernels' layout."""
    params = np.concatenate([head, np.array([dt], np.float32)])
    if params.size != _lib.library().lib.pfh_jvp_param_floats():
        raise RuntimeError(f"{name}: parameter block does not match the "
                           "kernel's JvpParams layout")
    return params


def make_fem_jvp(grid: CrossedTriGrid, tangent, n_fields: int, *, name: str,
                 symbol: str, constants: tuple[float, ...],
                 device: torch.device | str, dirichlet=(), variant=()):
    """``tangent(ctx, tctx) -> (source, flux)`` is the pointwise tangent of
    the benchmark's terms that the kernel computes, ``name`` the launch
    counter, ``symbol`` the C launcher, ``constants`` the physics constants
    in the kernel's order, ``variant`` the launcher's int arguments after
    the point count (kernel F's field count and operator). ``jv.plain`` and
    ``jv.kernel`` are the two versions; ``jv.launch`` (GatherLaunch) is what
    the kernel's launcher receives; ``jv.tangent`` is ``tangent`` (kernel
    N's plan reads both, ops/node_blocks.py); ``jv.n_fields`` is F."""
    if grid.periodic or grid.pad_to != (1, 1):
        raise NotImplementedError(f"{name} takes unpadded, non-periodic grids")
    tangent_jv = make_tangent_jvp(grid, tangent, device=device,
                                  dirichlet=dirichlet, dtype=torch.float32)
    vshape, mshape = (n_fields,) + grid.vshape, (n_fields,) + grid.mshape
    mask_np = bc_mask(grid, dirichlet, n_fields)
    launch = GatherLaunch(
        kind=symbol.removeprefix("pfh_").removesuffix("_jvp"),
        head=params_head(grid, constants, name), nq=grid.tab().nq,
        variant=tuple(variant),
        mask=None if mask_np is None else torch.as_tensor(mask_np, device=device),
        dims=(grid.ny, grid.nx), n_fields=n_fields)
    mask = launch.mask

    def plain(w, w0, dt, v, b=None):
        jv_ = tangent_jv(w, w0, dt, v)
        return jv_ if b is None else (b[0] - jv_[0], b[1] - jv_[1])

    def kernel(w, w0, dt, v, b=None):
        del w0  # the tangents do not read the previous time level
        ts = [*w, *v] + ([*b] if b is not None else [])
        _lib.check_cuda(name, ts + ([mask] if mask is not None else []))
        for pair in (w, v) if b is None else (w, v, b):
            _lib.check_shapes(name, pair, vshape, mshape)
        out = (torch.empty_like(v[0]), torch.empty_like(v[1]))
        params = with_dt(launch.head, dt, name)
        bv, bm = (None, None) if b is None else (b[0].data_ptr(), b[1].data_ptr())
        _lib.library().call(
            symbol, params.ctypes.data, launch.nq, *launch.variant,
            w[0].data_ptr(), w[1].data_ptr(), v[0].data_ptr(), v[1].data_ptr(),
            bv, bm, None if mask is None else mask.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), grid.ny, grid.nx,
            _lib.stream_handle())
        _lib.count_launch(name)
        return out

    def jv(w, w0, dt, v, b=None):
        return (plain if _lib.on_cpu(v[0]) else kernel)(w, w0, dt, v, b)

    jv.plain = plain
    jv.kernel = kernel
    jv.launch = launch
    jv.tangent = tangent
    jv.n_fields = n_fields
    return jv
