"""Kernels B, C and L of the LMR smoother (``csrc/block_jacobi.cu``,
``csrc/lmr.cu``, ``csrc/lmr_loop.cuh``) and the sweep loops.

B, ``block_jacobi_apply``: ``z = P^-1 r`` from the F x F node-block planes,
replacing ``_bj_apply`` of ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py``.

C, ``lmr_step``: ``alpha = <Az, r>/<Az, Az>`` (0 when the denominator is 0),
then ``x += alpha z`` and ``r -= alpha Az``, replacing ``_lmr_alpha`` and the
sweep-body axpys of ``make_fused_vcycle``. It updates ``x`` and ``r`` in
place: a sweep then allocates only ``z`` and ``Az``.

Both take a 2D pair ``(v, m)`` or a 3D 1-leaf state ``(v,)`` (one vertex
grid ``[F, Z, Y, X]``, fem/grid3d.py; the launchers then get no centre planes
and ``ncell = 0``), and optional field groups (``SolverConfig.field_split``): contiguous
field ranges such as BM2's ``((0, 1), (2,), (3,), (4,), (5,))``. B then sums
each output over its own group's planes only (``_bj_apply(groups)``), and C
forms one alpha per group (``_lmr_alpha(groups)``).

L, ``lmr_sweep`` (``make_lmr_sweep_loop``'s kernel): the n sweeps of a
gather level in one launch, B's body, the level J.v's gather body and C's
two stages in each, with grid barriers between them. It replaces
``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_lmr_sweep_loop``
and ``make_pallas_lmr_sweep`` (n sweeps in one Pallas call) and
``ops/pallas_tiled.py:make_tiled_lmr_sweep`` (the same sweeps over row
blocks, with partial dots and alpha outside the kernel: L's slots), and in
3D ``ops/pallas3d.py:make_pallas_lmr_sweep_loop3d`` and
``make_tiled_lmr_sweep3d`` (z slabs instead of row blocks). It takes the
level's physics from ``jv.launch`` (ops/fem_jvp.GatherLaunch), its Dirichlet
mask with it (2D, and a 3D level of bench6_3d, whose launches count as
``lmr_loop_chp3d``), and gives the bits of the launch sequence B, the level
J.v, C per sweep, which stays as ``sweep.sequence``. On a level routed to the tile kernels (ops/fem_tile.py)
``make_tile_sweep_loop`` is a sequence of TS (B and the level J.v in one
launch) and C; ``make_level_sweep_loop`` picks by the level's J.v.

``lmr_partials`` and ``lmr_update`` are C's two stages alone (one alpha):
the sharded smoother (parallel/halo_smoother.py) adds the shards' partials
between them, the counterpart of the ``psum`` of ``pfhubbenchmarks_tpu/
parallel/halo_smoother.py``.

Each has its plain PyTorch version beside it (einsums; torch dots and
axpys), which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import with_dt
from pfhubbenchmarks_tpu_torch.ops.fem_jvp3d import with_dt3

_LMR_THREADS = 256
_LMR_MAX_BLOCKS = 64
_MAX_GROUPS = 8


def group_starts(field_groups) -> tuple[int, ...] | None:
    """``((0, 1), (2,), ...)`` -> the start of each group and the field
    count, ``(0, 2, 3, ...)``; None for no groups. The groups must be
    contiguous, in order, and cover the fields from 0."""
    if field_groups is None:
        return None
    starts = [0]
    for grp in field_groups:
        if tuple(grp) != tuple(range(starts[-1], starts[-1] + len(grp))) or not grp:
            raise ValueError(f"field groups {field_groups} are not contiguous "
                             "ranges in order from field 0")
        starts.append(starts[-1] + len(grp))
    if len(starts) - 1 > _MAX_GROUPS:
        raise ValueError(f"at most {_MAX_GROUPS} field groups")
    return tuple(starts)


def _check_groups(name, starts, F):
    if starts is not None and starts[-1] != F:
        raise ValueError(f"{name}: groups {starts} do not cover {F} fields")


def c_groups(starts):
    """(n_groups, int array or None) for the C launchers."""
    if starts is None:
        return 0, None
    return len(starts) - 1, (ctypes.c_int * len(starts))(*starts)


def _leaves(name, *states):
    """The leaf count of a 2D pair or a 3D 1-leaf state, shared by all."""
    n = len(states[0])
    if n not in (1, 2) or any(len(s) != n for s in states):
        raise ValueError(f"{name}: states must all be (v, m) pairs or all (v,)")
    return n


def _bj_einsum(P, rl):
    """z_i = sum_j P_ij r_j per node, for [F, Y, X] or [F, Z, Y, X] planes."""
    sp = "zyx"[3 - (rl.dim() - 1):]
    return torch.einsum(f"ij{sp},j{sp}->i{sp}", P, rl)


def block_jacobi_apply_plain(pinv, r, groups=None):
    starts = group_starts(groups)
    _leaves("block_jacobi_apply", pinv, r)
    if starts is None:
        return tuple(_bj_einsum(P, rl) for P, rl in zip(pinv, r))
    _check_groups("block_jacobi_apply", starts, r[0].shape[0])
    out = []
    for P, rl in zip(pinv, r):
        out.append(torch.cat([_bj_einsum(P[a:b, a:b], rl[a:b])
                              for a, b in zip(starts[:-1], starts[1:])]))
    return tuple(out)


def _ptrs(pair):
    """(v, m) or (v,) -> the v and m pointers (None for no centre grid)."""
    return pair[0].data_ptr(), (pair[1].data_ptr() if len(pair) == 2 else None)


def _ncell(pair) -> int:
    return pair[1][0].numel() if len(pair) == 2 else 0


def block_jacobi_apply_kernel(pinv, r, groups=None):
    starts = group_starts(groups)
    _leaves("block_jacobi_apply", pinv, r)
    F = r[0].shape[0]
    _lib.check_cuda("block_jacobi_apply", [*pinv, *r])
    if any(P.shape != (F, F) + rl.shape[1:] for P, rl in zip(pinv, r)):
        raise ValueError(f"block_jacobi_apply: planes "
                         f"{[tuple(P.shape) for P in pinv]} vs r "
                         f"{[tuple(rl.shape) for rl in r]}")
    _check_groups("block_jacobi_apply", starts, F)
    z = tuple(torch.empty_like(rl) for rl in r)
    _lib.library().call(
        "pfh_block_jacobi_apply", *_ptrs(pinv), *_ptrs(r), *_ptrs(z), F,
        r[0][0].numel(), _ncell(r), *c_groups(starts), _lib.stream_handle())
    _lib.count_launch("block_jacobi_apply")
    return z


def block_jacobi_apply(pinv, r, groups=None):
    """z = P^-1 r with pinv = (pv [F,F,Yv,Xv], pm [F,F,Ym,Xm]), or in 3D
    (pv [F,F,Z,Y,X],); with ``groups`` only the in-group planes are read."""
    if _lib.on_cpu(r[0]):
        return block_jacobi_apply_plain(pinv, r, groups)
    return block_jacobi_apply_kernel(pinv, r, groups)


def lmr_partials_plain(az, r):
    """[<Az, r>, <Az, Az>] over the leaves, f32."""
    num = den = None
    for a, rl in zip(az, r):
        a, rl = a.reshape(-1), rl.reshape(-1)
        n_l, d_l = torch.vdot(a, rl), torch.vdot(a, a)
        num = n_l if num is None else num + n_l
        den = d_l if den is None else den + d_l
    return torch.stack([num, den])


def _alpha(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(den))


def lmr_alpha_plain(az, r):
    return _alpha(*lmr_partials_plain(az, r))


def _axpys(alpha, x, r, z, az) -> None:
    for xl, zl in zip(x, z):
        xl.add_(alpha * zl)
    for rl, al in zip(r, az):
        rl.sub_(alpha * al)


def lmr_step_plain(x, r, z, az, groups=None) -> None:
    starts = group_starts(groups)
    if starts is None:
        alpha = lmr_alpha_plain(az, r)
    else:
        _check_groups("lmr_step", starts, x[0].shape[0])
        per_group = [lmr_alpha_plain(tuple(t[a:b] for t in az),
                                     tuple(t[a:b] for t in r))
                     for a, b in zip(starts[:-1], starts[1:])]
        alpha = torch.cat([a.expand(b - s) for a, s, b in
                           zip(per_group, starts[:-1], starts[1:])])
        alpha = alpha.reshape((-1,) + (1,) * (x[0].dim() - 1))
    _axpys(alpha, x, r, z, az)


def lmr_partial_blocks(n: int) -> int:
    """Stage-1 block count: a function of the vector length only, so the
    reduction order (and the result bits) never changes between runs."""
    return max(1, min(_LMR_MAX_BLOCKS, -(-n // _LMR_THREADS)))


def lmr_step_kernel(x, r, z, az, groups=None) -> torch.Tensor:
    """Returns the device alphas, one per group (for inspection; never read
    here)."""
    starts = group_starts(groups)
    _leaves("lmr_step", x, r, z, az)
    _lib.check_cuda("lmr_step", [*x, *r, *z, *az])
    for pair in (r, z, az):
        if any(a.shape != b.shape for a, b in zip(pair, x)):
            raise ValueError("lmr_step: x, r, z and Az must share shapes")
    F = x[0].shape[0]
    _check_groups("lmr_step", starts, F)
    n_groups, c_starts = c_groups(starts)
    nb = lmr_partial_blocks(sum(t.numel() for t in x))
    dev = x[0].device
    partials = torch.empty(2 * max(n_groups, 1) * nb, dtype=torch.float64,
                           device=dev)
    alpha = torch.empty(max(n_groups, 1), dtype=torch.float32, device=dev)
    _lib.library().call(
        "pfh_lmr_step", *_ptrs(x), *_ptrs(r), *_ptrs(z), *_ptrs(az),
        x[0][0].numel(), _ncell(x), F, n_groups, c_starts, partials.data_ptr(),
        nb, alpha.data_ptr(), _lib.stream_handle())
    _lib.count_launch("lmr_step")
    return alpha


def lmr_step(x, r, z, az, groups=None) -> None:
    """One LMR update of (x, r), in place; one alpha per group of
    ``groups`` (a single alpha without)."""
    if _lib.on_cpu(x[0]):
        lmr_step_plain(x, r, z, az, groups)
    else:
        lmr_step_kernel(x, r, z, az, groups)


# C's two stages alone, one alpha (no field groups): the sharded smoother
# (parallel/halo_smoother.py) sums the shards' partials between them. Each
# wrapper counts one ``lmr_step`` launch.

def lmr_partials_kernel(az, r) -> torch.Tensor:
    """Stage 1: the ``2 nb`` f64 block partials of <Az, r> and <Az, Az>,
    ``nb`` a function of the vector length only."""
    _leaves("lmr_partials", az, r)
    _lib.check_cuda("lmr_partials", [*az, *r])
    if any(a.shape != b.shape for a, b in zip(az, r)):
        raise ValueError("lmr_partials: Az and r must share shapes")
    nb = lmr_partial_blocks(sum(t.numel() for t in r))
    partials = torch.empty(2 * nb, dtype=torch.float64, device=r[0].device)
    _lib.library().call(
        "pfh_lmr_partials", *_ptrs(az), *_ptrs(r), r[0][0].numel(), _ncell(r),
        r[0].shape[0], 0, None, partials.data_ptr(), nb, _lib.stream_handle())
    _lib.count_launch("lmr_step")
    return partials


def lmr_update_kernel(partials, x, r, z, az) -> torch.Tensor:
    """Stage 2: alpha from ``partials`` (summed in index order), then
    ``x += alpha z``, ``r -= alpha Az`` in place. Returns the device alpha."""
    _leaves("lmr_update", x, r, z, az)
    _lib.check_cuda("lmr_update", [*x, *r, *z, *az])
    _lib.check_cuda("lmr_update", [partials], dtype=torch.float64)
    for pair in (r, z, az):
        if any(a.shape != b.shape for a, b in zip(pair, x)):
            raise ValueError("lmr_update: x, r, z and Az must share shapes")
    nb = partials.numel() // 2
    alpha = torch.empty(1, dtype=torch.float32, device=x[0].device)
    _lib.library().call(
        "pfh_lmr_update", partials.data_ptr(), nb, *_ptrs(x), *_ptrs(r),
        *_ptrs(z), *_ptrs(az), x[0][0].numel(), _ncell(x), x[0].shape[0], 0,
        None, alpha.data_ptr(), _lib.stream_handle())
    _lib.count_launch("lmr_step")
    return alpha


def lmr_update_plain(partials, x, r, z, az) -> None:
    _axpys(_alpha(*partials), x, r, z, az)


def lmr_partials(az, r) -> torch.Tensor:
    """Stage 1 of C: the kernel's block partials on the card, ``[num, den]``
    (f32) on the CPU. Partials of equal shapes add up elementwise."""
    if _lib.on_cpu(r[0]):
        return lmr_partials_plain(az, r)
    return lmr_partials_kernel(az, r)


def lmr_update(partials, x, r, z, az) -> None:
    """Stage 2 of C on ``lmr_partials``' (summed) output, in place."""
    if _lib.on_cpu(x[0]):
        lmr_update_plain(partials, x, r, z, az)
    else:
        lmr_update_kernel(partials, x, r, z, az)


def _leaf_shapes(dims):
    """The node planes of a level with ``dims`` cells: (v, m) in 2D, (v,)
    in 3D."""
    if len(dims) == 3:
        return (tuple(d + 1 for d in dims),)
    ny, nx = dims
    return (ny + 1, nx + 1), (ny, nx)


def lmr_sweep_kernel(launch, n_sweeps: int, x, r, w, dt, pinv, groups=None,
                     *, one_cta=False) -> int:
    """Kernel L: ``n_sweeps`` LMR sweeps of the level whose gather J.v
    ``launch`` describes (``jv.launch``, ops/fem_jvp.GatherLaunch) on (x, r),
    in place, in one launch; ``w`` the state, ``pinv`` the block planes.
    It runs the cooperative grid of min(blocks needed, co-resident CTAs);
    ``one_cta`` one CTA synced by __syncthreads instead, which on the H100
    is 1.8-40x slower than the grid at every level of the main paths, 25^2
    included (chip_smoke.py phase 22). Returns the CTAs run."""
    starts = group_starts(groups)
    shapes = _leaf_shapes(launch.dims)
    if _leaves("lmr_sweep", x, r, w, pinv) != len(shapes):
        raise ValueError(f"lmr_sweep: a level of {len(launch.dims)} dims "
                         f"takes {len(shapes)}-leaf states")
    F = launch.n_fields
    for pair in (x, r, w):
        if any(tuple(t.shape) != (F,) + s for t, s in zip(pair, shapes)):
            raise ValueError(f"lmr_sweep: shapes {[tuple(t.shape) for t in pair]}"
                             f", expected {[(F,) + s for s in shapes]}")
    if any(tuple(t.shape) != (F, F) + s for t, s in zip(pinv, shapes)):
        raise ValueError(f"lmr_sweep: planes {[tuple(t.shape) for t in pinv]}")
    mask = [] if launch.mask is None else [launch.mask]
    _lib.check_cuda("lmr_sweep", [*x, *r, *w, *pinv, *mask])
    _check_groups("lmr_sweep", starts, F)
    if n_sweeps < 1:
        return 0
    n_nodes = sum(math.prod(s) for s in shapes)
    n_groups, c_starts = c_groups(starts)
    nb = lmr_partial_blocks(F * n_nodes)
    z = tuple(torch.empty_like(t) for t in x)
    az = tuple(torch.empty_like(t) for t in x)
    partials = torch.empty(2 * max(n_groups, 1) * nb, dtype=torch.float64,
                           device=x[0].device)
    grid = ctypes.c_int(0)
    mask_ptr = None if launch.mask is None else launch.mask.data_ptr()
    head = (partials.data_ptr(), nb, n_groups, c_starts, n_sweeps,
            *launch.dims)
    tail = (int(one_cta), ctypes.byref(grid), _lib.stream_handle())
    lib = _lib.library()
    if len(shapes) == 1:
        # a 3D level's mask comes after its cells
        params = with_dt3(launch.head, dt, "lmr_sweep")
        lib.call("pfh_lmr_loop_" + launch.kind, params.ctypes.data, launch.nq,
                 x[0].data_ptr(), r[0].data_ptr(), z[0].data_ptr(),
                 az[0].data_ptr(), pinv[0].data_ptr(), w[0].data_ptr(), *head,
                 mask_ptr, *tail)
    else:
        params = with_dt(launch.head, dt, "lmr_sweep")
        lib.call("pfh_lmr_loop_" + launch.kind, params.ctypes.data, launch.nq,
                 *launch.variant, *_ptrs(x), *_ptrs(r), *_ptrs(z), *_ptrs(az),
                 *_ptrs(pinv), *_ptrs(w), mask_ptr, *head, *tail)
    _lib.count_launch(_lib.COUNTED_AS.get(("lmr_sweep", launch.kind),
                                          "lmr_sweep"))
    return grid.value


def _sweep_body(z_az, n_sweeps, field_groups):
    """``body(version, x, r, w, w0, dt, *pinv)``: ``n_sweeps`` LMR sweeps
    on (x, r) in place, each ``(z, A z) = z_az(version, r, w, w0, dt,
    pinv)`` and the step (C, or its plain version)."""
    group_starts(field_groups)
    steps = {"kernel": lmr_step_kernel, "plain": lmr_step_plain}

    def body(version, x, r, w, w0, dt, *pinv):
        for _ in range(n_sweeps):
            z, az = z_az(version, r, w, w0, dt, pinv)
            steps[version](x, r, z, az, field_groups)
        return x, r

    return body


def _sweep(name, kernel, plain):
    """``sweep(x, r, w, w0, dt, *pinv)``: ``plain`` for CPU tensors, else
    ``kernel``; both are attributes, with the loop's ``name``."""
    def sweep(x, r, w, w0, dt, *pinv):
        return (plain if _lib.on_cpu(x[0]) else kernel)(x, r, w, w0, dt, *pinv)

    sweep.kernel, sweep.plain, sweep.name = kernel, plain, name
    return sweep


def make_lmr_sweep_loop(jv, n_sweeps: int, field_groups=None):
    """Returns ``sweep(x, r, w, w0, dt, *pinv) -> (x, r)``, the signature of
    the TPU sweep kernels (``pinv`` the block planes, one per leaf of the
    state: ``pinv_v, pinv_m`` in 2D, ``pinv_v`` in 3D): ``n_sweeps`` LMR
    sweeps on (x, r), updated in place and returned. A sweep is ``z = P^-1
    r`` (reading the in-group planes of ``field_groups``), ``A z`` by ``jv``
    (the level's gather J.v, ops/fem_jvp.make_fem_jvp or
    ops/fem_jvp3d.make_fem_jvp3d) and the step (one alpha per group of
    ``field_groups``). ``sweep.kernel`` is kernel L, all sweeps in one
    launch of the body ``jv.launch`` describes; ``sweep.sequence`` the
    launch sequence B, ``jv.kernel`` and C per sweep, with the same bits;
    ``sweep.plain`` their plain versions."""
    bj = {"kernel": block_jacobi_apply_kernel, "plain": block_jacobi_apply_plain}

    def z_az(version, r, w, w0, dt, pinv):
        z = bj[version](pinv, r, field_groups)
        return z, getattr(jv, version)(w, w0, dt, z)

    body = _sweep_body(z_az, n_sweeps, field_groups)

    def kernel(x, r, w, w0, dt, *pinv):
        del w0  # the tangents do not read the previous time level
        lmr_sweep_kernel(jv.launch, n_sweeps, x, r, w, dt, pinv, field_groups)
        return x, r

    sweep = _sweep("lmr_sweep_loop", kernel, functools.partial(body, "plain"))
    sweep.sequence = functools.partial(body, "kernel")
    return sweep


def make_tile_sweep_loop(ts, n_sweeps: int, field_groups=None):
    """The tiled sweep loop, with ``make_lmr_sweep_loop``'s signature: a
    sweep is ``(z, A z)`` by the tile kernel TS (``ts``, the ``tile_sweep``
    of the level's seam-form J.v, ops/fem_tile.py: block-Jacobi and A z in
    one launch, then the seam fold), then the step (C). It replaces the
    sweep of ``pfhubbenchmarks_tpu/ops/pallas_tiled_grid.py:
    make_grid_tiled_lmr_sweep`` (its kernel, then alpha and the axpys
    outside). ``sweep.kernel`` counts one ``tile_sweep_loop`` call."""

    def z_az(version, r, w, w0, dt, pinv):
        return getattr(ts, version)(w, w0, dt, r, pinv, field_groups)

    body = _sweep_body(z_az, n_sweeps, field_groups)

    def kernel(*args):
        out = body("kernel", *args)
        _lib.count_call("tile_sweep_loop")
        return out

    return _sweep("tile_sweep_loop", kernel, functools.partial(body, "plain"))


def make_level_sweep_loop(jv, n_sweeps: int, field_groups=None):
    """The sweep loop of a level whose J.v is ``jv``: the tiled loop where
    the level is routed to the tile kernels (``jv.tile_sweep``, a seam-form
    J.v of ops/fem_tile.py), else ``make_lmr_sweep_loop``."""
    ts = getattr(jv, "tile_sweep", None)
    if ts is None:
        return make_lmr_sweep_loop(jv, n_sweeps, field_groups)
    return make_tile_sweep_loop(ts, n_sweeps, field_groups)
