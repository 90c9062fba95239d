"""Kernels U (``csrc/ch3d_tile.cu`` over ``csrc/fem_tet_tile.cuh``) and I
(``csrc/ch3d_jvp.cu`` over ``csrc/fem_jvp3d.cuh``): the 3D Kuhn-tet J.v, and
its plain version beside them.

Replace ``pfhubbenchmarks_tpu/ops/pallas3d.py:make_tiled_jvp3d`` (the J.v
over z slabs with halo planes, each cell evaluated once per slab) and
``make_pallas_jvp3d`` (the whole-array 3D J.v). U, the launch of every CUDA
call, evaluates each Kuhn tet of a shared-memory box of vertices once
(``TET_BOX``, one CTA per box); I, the gather form (each tet once per vertex),
stays as ``jv.gather``, U's comparison.

``make_fem_jvp3d`` returns ``jv(w, w0, dt, v, b=None)``: ``J(w, w0, dt) v``,
or ``b - J v`` when ``b`` is given, as an f32 1-leaf state ``(v,)``. One
kernel serves the 1-, 4- and 8-point tet rules (keast1, keast2 on the
multigrid levels, ffc3 for the outer matvec): the tabulation, the physics
constants and ``dt`` are launch arguments. ``make_ch3d_jvp`` is U (and I)
for bench1_3d's Cahn-Hilliard; ``make_chp3d_jvp`` U for bench6_3d's
Cahn-Hilliard + Poisson (``chp3d_tile``, csrc/chp3d_tile.cu), whose face
Dirichlet rows of phi (``DirichletBC3D``) the kernel's store sets to ``v``
(or ``b - v``) from a 0/1 mask (fem/assembly3d.bc_mask3d): the J.v of a
residual whose rows there are ``u - g``. It replaces no TPU kernel (the JAX
package runs bench6_3d's J.v on XLA); I is not built at its physics.

The plain version is the benchmark's hand-written pointwise ``tangent``
(which the kernels' ``Phys::tangent`` mirrors) assembled in f32 by the
residual's einsums (fem/assembly3d.make_tangent_jvp3d): the function
``torch.func.jvp`` of the residual computes, without forward AD. The wrapper
takes it for CPU tensors only; a CUDA tensor launches U.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly3d import (bc_mask3d,
                                                      make_tangent_jvp3d)
from pfhubbenchmarks_tpu_torch.fem.grid3d import _TETS, TetGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import GatherLaunch

MAX_Q = 8
RULE_POINTS = (1, 4, 8)
MAX_CONST = 12
# physics constants of kernels I and U, in their parameter order
CH_CONSTANTS = ("M", "kappa", "rho_s", "c_alpha", "c_beta")
CHP_CONSTANTS = ("M", "kappa", "rho", "c_alpha", "c_beta", "k", "epsilon")
# Kernel U's box: the owned vertices along (z, y, x) (csrc/fem_tet_tile.cuh
# kBoxZ, kBoxY, kBoxX; tests/test_torch_tet_tile.py holds them equal).
TET_BOX = (7, 7, 7)


def tet_boxes(dims) -> tuple[int, ...]:
    """Kernel U's boxes along each axis of a grid of ``dims`` = (nz, ny, nx)
    cells: ceil((n + 1) / B), one CTA each, x fastest."""
    return tuple((n + b) // b for n, b in zip(dims, TET_BOX))


def box_ranges(dims, box) -> tuple[tuple[range, range], ...]:
    """Per axis (z, y, x) of box ``box`` = (bz, by, bx): the vertices it owns
    and the cells it evaluates, the cells incident to those vertices (one
    halo cell layer below the owned ones), clipped to the grid."""
    out = []
    for n, b, i in zip(dims, TET_BOX, box):
        o = i * b
        out.append((range(o, min(o + b, n + 1)),
                    range(max(o - 1, 0), min(o + b, n))))
    return tuple(out)


def recompute_factor(dims) -> float:
    """The cells U evaluates over the grid's cells (each box's cell ranges
    multiply per axis, so the sum over boxes does too)."""
    f = 1.0
    for a, (n, nb) in enumerate(zip(dims, tet_boxes(dims))):
        box = [0, 0, 0]
        total = 0
        for i in range(nb):
            box[a] = i
            total += len(box_ranges(dims, box)[a][1])
        f *= total / n
    return f


def pack_tabulation3d(grid: TetGrid) -> np.ndarray:
    """The kernel's float32 tables (``Jvp3Params`` without the constants and
    dt): per tet only its 4 vertices, the point axis zero-padded to 8. The
    barycentric basis values are the same in every Kuhn tet, so one [8, 4]
    table serves all six."""
    tab = grid.tab()
    nq = tab.nq
    if nq not in RULE_POINTS:
        raise ValueError(f"kernels I and U take rules of {RULE_POINTS} points, rule "
                         f"{grid.rule_name!r} has {nq}")
    loc = [tab.Bq[t][:, _TETS[t]] for t in range(6)]      # [nq, 4] each
    if any(not np.array_equal(b, loc[0]) for b in loc):
        raise ValueError("tet tabulations differ in their basis values")
    Bq = np.zeros((MAX_Q, 4))
    Bq[:nq] = loc[0]
    WB = np.zeros((6, MAX_Q, 4))
    WG = np.zeros((6, MAX_Q, 4, 3))
    Gs = np.zeros((6, 4, 3))
    for t in range(6):
        slots = _TETS[t]
        WB[t, :nq] = (tab.wq[:, :, None] * tab.Bq)[t][:, slots]
        for d in range(3):
            WG[t, :nq, :, d] = (tab.wq[:, :, None]
                                * tab.Gs[:, None, :, d])[t][:, slots]
        Gs[t] = tab.Gs[t][slots]
    return np.concatenate([a.reshape(-1) for a in (Bq, WB, WG, Gs)]).astype(
        np.float32)


def with_dt3(head: np.ndarray, dt: float, name: str) -> np.ndarray:
    """The whole 3D parameter block, checked against the kernels'
    ``Jvp3Params`` layout."""
    params = np.concatenate([head, np.array([dt], np.float32)])
    if params.size != _lib.library().lib.pfh_jvp3_param_floats():
        raise RuntimeError(f"{name}: parameter block does not match the "
                           "kernel's Jvp3Params layout")
    return params


def make_fem_jvp3d(grid: TetGrid, tangent, n_fields: int, *, kind: str,
                   constants: tuple[float, ...], device: torch.device | str,
                   dirichlet=(), masked: bool = False, gather: bool = True):
    """``tangent(ctx, tctx) -> (source, flux)`` is the pointwise tangent of
    the benchmark's terms that the kernels compute, ``kind`` the physics of
    the C launchers (``pfh_{kind}_tile``, U; ``pfh_{kind}_jvp``, I; and kernel
    L's ``pfh_lmr_loop_{kind}``), whose names also count the launches;
    ``constants`` the physics constants in the kernels' order; ``dirichlet``
    the ``DirichletBC3D`` faces, whose rows are ``v`` (identity rows), which
    only a ``masked`` instantiation (kMask) takes; ``gather``: kernel I is
    built at this physics. ``jv.plain`` and ``jv.kernel`` (U) are the two
    versions, ``jv.gather`` kernel I; ``jv.launch`` (ops/fem_jvp.GatherLaunch)
    is what the kernels' launchers receive."""
    if grid.pad_to != (1, 1, 1):
        raise NotImplementedError(f"{kind}: the 3D kernels take unpadded grids")
    if len(constants) > MAX_CONST:
        raise ValueError(f"{kind}: at most {MAX_CONST} constants")
    if dirichlet and not masked:
        raise NotImplementedError(f"{kind}: the kernels have no Dirichlet rows "
                                  "at this physics")
    tangent_jv = make_tangent_jvp3d(grid, tangent, device=device,
                                    dirichlet=dirichlet, dtype=torch.float32)
    const = np.zeros(MAX_CONST, np.float32)
    const[: len(constants)] = constants
    mask_np = bc_mask3d(grid, dirichlet, n_fields)
    launch = GatherLaunch(
        kind=kind, head=np.concatenate([pack_tabulation3d(grid), const]),
        nq=grid.tab().nq, variant=(),
        mask=None if mask_np is None else torch.as_tensor(mask_np, device=device),
        dims=(grid.nz, grid.ny, grid.nx), n_fields=n_fields)
    vshape = (n_fields,) + grid.vshape

    def plain(w, w0, dt, v, b=None):
        (jv_,) = tangent_jv(w, w0, dt, v)
        return (jv_,) if b is None else (b[0] - jv_,)

    def launcher(name, with_mask):
        def run(w, w0, dt, v, b=None):
            del w0  # the tangents do not read the previous time level
            ts = [w[0], v[0]] + ([b[0]] if b is not None else [])
            mask = launch.mask if with_mask else None
            _lib.check_cuda(name, ts + ([mask] if mask is not None else []))
            for t in ts:
                if tuple(t.shape) != vshape:
                    raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                                     f"expected {vshape}")
            out = torch.empty_like(v[0])
            params = with_dt3(launch.head, dt, name)
            # U's launchers take the mask after b (null: none); I's take none
            mask_arg = ((None if mask is None else mask.data_ptr(),)
                        if with_mask else ())
            _lib.library().call(
                f"pfh_{name}", params.ctypes.data, launch.nq, w[0].data_ptr(),
                v[0].data_ptr(), None if b is None else b[0].data_ptr(),
                *mask_arg, out.data_ptr(), grid.nz, grid.ny, grid.nx,
                _lib.stream_handle())
            _lib.count_launch(name)
            return (out,)
        return run

    kernel = launcher(f"{kind}_tile", True)

    def jv(w, w0, dt, v, b=None):
        return (plain if _lib.on_cpu(v[0]) else kernel)(w, w0, dt, v, b)

    def not_built(*args, **kw):
        raise NotImplementedError(f"kernel I is not built at the physics "
                                  f"{kind!r}")

    jv.plain = plain
    jv.kernel = kernel
    jv.gather = launcher(f"{kind}_jvp", False) if gather else not_built
    jv.launch = launch
    return jv


def make_ch3d_jvp(grid: TetGrid, tangent, constants: dict, *,
                  device: torch.device | str, dirichlet=()):
    """Kernel U (and I as ``jv.gather``) for the 2-field (c, mu) system of
    bench1_3d; ``tangent`` is bench1's ``terms_tangent``
    (benchmarks/bench1.make_terms). Its kernels have no Dirichlet rows."""
    return make_fem_jvp3d(grid, tangent, 2, kind="ch3d",
                          constants=tuple(constants[k] for k in CH_CONSTANTS),
                          device=device, dirichlet=dirichlet)


def make_chp3d_jvp(grid: TetGrid, tangent, constants: dict, *,
                   device: torch.device | str, dirichlet=()):
    """Kernel U at BM6's physics (``chp3d_tile``) for the 3-field (c, mu,
    phi) system of bench6_3d, with the rows of the ``DirichletBC3D`` faces
    ``dirichlet`` set to ``v`` by the mask; ``tangent`` is bench6's
    ``terms_tangent`` (benchmarks/bench6.make_terms). Kernel L's 3D form at
    this physics is ``lmr_loop_chp3d``; ``jv.gather`` raises (I is not built
    here)."""
    return make_fem_jvp3d(grid, tangent, 3, kind="chp3d",
                          constants=tuple(constants[k] for k in CHP_CONSTANTS),
                          device=device, dirichlet=dirichlet, masked=True,
                          gather=False)
