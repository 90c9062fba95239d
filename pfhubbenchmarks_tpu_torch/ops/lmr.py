"""Kernels B and C of the LMR smoother (``csrc/block_jacobi.cu``,
``csrc/lmr.cu``) and the sweep loop built from them.

B, ``block_jacobi_apply``: ``z = P^-1 r`` from the F x F node-block planes,
replacing ``_bj_apply`` of ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py``.

C, ``lmr_step``: ``alpha = <Az, r>/<Az, Az>`` (0 when the denominator is 0),
then ``x += alpha z`` and ``r -= alpha Az``, replacing ``_lmr_alpha`` and the
sweep-body axpys of ``make_fused_vcycle``. It updates ``x`` and ``r`` in
place: a sweep then allocates only ``z`` and ``Az``.

Both take optional field groups (``SolverConfig.field_split``): contiguous
field ranges such as BM2's ``((0, 1), (2,), (3,), (4,), (5,))``. B then sums
each output over its own group's planes only (``_bj_apply(groups)``), and C
forms one alpha per group (``_lmr_alpha(groups)``).

``make_lmr_sweep_loop`` replaces ``pfhubbenchmarks_tpu/ops/
pallas_residual.py:make_pallas_lmr_sweep_loop`` and ``make_pallas_lmr_sweep``
(n sweeps in one Pallas call) and ``ops/pallas_tiled.py:
make_tiled_lmr_sweep`` (the same sweeps over row blocks, with partial dots
and alpha outside the kernel, which is what C's two stages do): a launch
sequence of B, the level J.v and C per sweep.

Each has its plain PyTorch version beside it (einsums; torch dots and
axpys), which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from pfhubbenchmarks_tpu_torch.ops import _lib

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


def _c_groups(starts):
    """(n_groups, int array or None) for the C launchers."""
    if starts is None:
        return 0, None
    return len(starts) - 1, (ctypes.c_int * len(starts))(*starts)


def block_jacobi_apply_plain(pinv, r, groups=None):
    starts = group_starts(groups)
    pv, pm = pinv
    if starts is None:
        return (torch.einsum("ijyx,jyx->iyx", pv, r[0]),
                torch.einsum("ijyx,jyx->iyx", pm, r[1]))
    _check_groups("block_jacobi_apply", starts, r[0].shape[0])
    out = []
    for P, rl in zip(pinv, r):
        out.append(torch.cat([torch.einsum("ijyx,jyx->iyx", P[a:b, a:b], rl[a:b])
                              for a, b in zip(starts[:-1], starts[1:])]))
    return tuple(out)


def block_jacobi_apply_kernel(pinv, r, groups=None):
    starts = group_starts(groups)
    pv, pm = pinv
    F = r[0].shape[0]
    _lib.check_cuda("block_jacobi_apply", [pv, pm, r[0], r[1]])
    if (pv.shape != (F, F) + r[0].shape[1:]
            or pm.shape != (F, F) + r[1].shape[1:]):
        raise ValueError(f"block_jacobi_apply: planes {tuple(pv.shape)}, "
                         f"{tuple(pm.shape)} vs r {tuple(r[0].shape)}, "
                         f"{tuple(r[1].shape)}")
    _check_groups("block_jacobi_apply", starts, F)
    z = (torch.empty_like(r[0]), torch.empty_like(r[1]))
    _lib.library().call(
        "pfh_block_jacobi_apply", pv.data_ptr(), pm.data_ptr(), r[0].data_ptr(),
        r[1].data_ptr(), z[0].data_ptr(), z[1].data_ptr(), F,
        r[0][0].numel(), r[1][0].numel(), *_c_groups(starts),
        _lib.stream_handle())
    _lib.count_launch("block_jacobi_apply")
    return z


def block_jacobi_apply(pinv, r, groups=None):
    """z = P^-1 r with pinv = (pv [F,F,Yv,Xv], pm [F,F,Ym,Xm]); with
    ``groups`` only the in-group planes are read."""
    if _lib.on_cpu(r[0]):
        return block_jacobi_apply_plain(pinv, r, groups)
    return block_jacobi_apply_kernel(pinv, r, groups)


def lmr_alpha_plain(az, r):
    num = torch.vdot(az[0].reshape(-1), r[0].reshape(-1)) + torch.vdot(
        az[1].reshape(-1), r[1].reshape(-1))
    den = torch.vdot(az[0].reshape(-1), az[0].reshape(-1)) + torch.vdot(
        az[1].reshape(-1), az[1].reshape(-1))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(den))


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
                           zip(per_group, starts[:-1], starts[1:])])[:, None, None]
    for xl, zl in zip(x, z):
        xl.add_(alpha * zl)
    for rl, al in zip(r, az):
        rl.sub_(alpha * al)


def lmr_partial_blocks(n: int) -> int:
    """Stage-1 block count: a function of the vector length only, so the
    reduction order (and the result bits) never changes between runs."""
    return max(1, min(_LMR_MAX_BLOCKS, -(-n // _LMR_THREADS)))


def lmr_step_kernel(x, r, z, az, groups=None) -> torch.Tensor:
    """Returns the device alphas, one per group (for inspection; never read
    here)."""
    starts = group_starts(groups)
    ts = [x[0], x[1], r[0], r[1], z[0], z[1], az[0], az[1]]
    _lib.check_cuda("lmr_step", ts)
    for pair in (r, z, az):
        if pair[0].shape != x[0].shape or pair[1].shape != x[1].shape:
            raise ValueError("lmr_step: x, r, z and Az must share shapes")
    F = x[0].shape[0]
    _check_groups("lmr_step", starts, F)
    n_groups, c_starts = _c_groups(starts)
    nb = lmr_partial_blocks(x[0].numel() + x[1].numel())
    dev = x[0].device
    partials = torch.empty(2 * max(n_groups, 1) * nb, dtype=torch.float64,
                           device=dev)
    alpha = torch.empty(max(n_groups, 1), dtype=torch.float32, device=dev)
    _lib.library().call(
        "pfh_lmr_step", *[t.data_ptr() for t in ts], x[0][0].numel(),
        x[1][0].numel(), F, n_groups, c_starts, partials.data_ptr(), nb,
        alpha.data_ptr(), _lib.stream_handle())
    _lib.count_launch("lmr_step")
    return alpha


def lmr_step(x, r, z, az, groups=None) -> None:
    """One LMR update of (x, r), in place; one alpha per group of
    ``groups`` (a single alpha without)."""
    if _lib.on_cpu(x[0]):
        lmr_step_plain(x, r, z, az, groups)
    else:
        lmr_step_kernel(x, r, z, az, groups)


def make_lmr_sweep_loop(jv, n_sweeps: int, field_groups=None):
    """Returns ``sweep(x, r, w, w0, dt, pinv_v, pinv_m) -> (x, r)``, the
    signature of the TPU sweep kernels: ``n_sweeps`` LMR sweeps on (x, r),
    updated in place and returned. A sweep is ``z = P^-1 r`` (B, reading
    the in-group planes of ``field_groups``), ``A z`` by ``jv`` (the level's
    J.v, ops/fem_jvp.make_fem_jvp) and the step (C, one alpha per group of
    ``field_groups``). ``sweep.plain`` runs the plain versions;
    ``sweep.kernel`` the kernels, counting one ``lmr_sweep_loop`` call in
    ``_lib.CALLS``."""
    group_starts(field_groups)

    def body(bj, step, jv_, x, r, w, w0, dt, pinv_v, pinv_m):
        for _ in range(n_sweeps):
            z = bj((pinv_v, pinv_m), r, field_groups)
            step(x, r, z, jv_(w, w0, dt, z), field_groups)
        return x, r

    def kernel(*args):
        out = body(block_jacobi_apply_kernel, lmr_step_kernel, jv.kernel, *args)
        _lib.count_call("lmr_sweep_loop")
        return out

    def plain(*args):
        return body(block_jacobi_apply_plain, lmr_step_plain, jv.plain, *args)

    def sweep(x, r, w, w0, dt, pinv_v, pinv_m):
        return (plain if _lib.on_cpu(x[0]) else kernel)(x, r, w, w0, dt,
                                                        pinv_v, pinv_m)

    sweep.kernel, sweep.plain = kernel, plain
    return sweep
