"""Kernels B and C of the LMR smoother (``csrc/block_jacobi.cu``,
``csrc/lmr.cu``).

B, ``block_jacobi_apply``: ``z = P^-1 r`` from the F x F node-block planes,
replacing ``_bj_apply`` of ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py``.

C, ``lmr_step``: ``alpha = <Az, r>/<Az, Az>`` (0 when the denominator is 0),
then ``x += alpha z`` and ``r -= alpha Az``, replacing ``_lmr_alpha`` and the
sweep-body axpys of ``make_fused_vcycle``. It updates ``x`` and ``r`` in
place: a sweep then allocates only ``z`` and ``Az``.

Each has its plain PyTorch version beside it (an einsum; torch dots and
axpys), which the wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.ops import _lib

_LMR_THREADS = 256
_LMR_MAX_BLOCKS = 64


def block_jacobi_apply_plain(pinv, r):
    pv, pm = pinv
    return (torch.einsum("ijyx,jyx->iyx", pv, r[0]),
            torch.einsum("ijyx,jyx->iyx", pm, r[1]))


def block_jacobi_apply_kernel(pinv, r):
    pv, pm = pinv
    F = r[0].shape[0]
    _lib.check_cuda("block_jacobi_apply", [pv, pm, r[0], r[1]])
    if (pv.shape != (F, F) + r[0].shape[1:]
            or pm.shape != (F, F) + r[1].shape[1:]):
        raise ValueError(f"block_jacobi_apply: planes {tuple(pv.shape)}, "
                         f"{tuple(pm.shape)} vs r {tuple(r[0].shape)}, "
                         f"{tuple(r[1].shape)}")
    z = (torch.empty_like(r[0]), torch.empty_like(r[1]))
    _lib.library().call(
        "pfh_block_jacobi_apply", pv.data_ptr(), pm.data_ptr(), r[0].data_ptr(),
        r[1].data_ptr(), z[0].data_ptr(), z[1].data_ptr(), F,
        r[0][0].numel(), r[1][0].numel(), _lib.stream_handle())
    _lib.count_launch("block_jacobi_apply")
    return z


def block_jacobi_apply(pinv, r):
    """z = P^-1 r with pinv = (pv [F,F,Yv,Xv], pm [F,F,Ym,Xm])."""
    if _lib.on_cpu(r[0]):
        return block_jacobi_apply_plain(pinv, r)
    return block_jacobi_apply_kernel(pinv, r)


def lmr_alpha_plain(az, r):
    num = torch.vdot(az[0].reshape(-1), r[0].reshape(-1)) + torch.vdot(
        az[1].reshape(-1), r[1].reshape(-1))
    den = torch.vdot(az[0].reshape(-1), az[0].reshape(-1)) + torch.vdot(
        az[1].reshape(-1), az[1].reshape(-1))
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       torch.zeros_like(den))


def lmr_step_plain(x, r, z, az) -> None:
    alpha = lmr_alpha_plain(az, r)
    for xl, zl in zip(x, z):
        xl.add_(alpha * zl)
    for rl, al in zip(r, az):
        rl.sub_(alpha * al)


def lmr_partial_blocks(n: int) -> int:
    """Stage-1 block count: a function of the vector length only, so the
    reduction order (and the result bits) never changes between runs."""
    return max(1, min(_LMR_MAX_BLOCKS, -(-n // _LMR_THREADS)))


def lmr_step_kernel(x, r, z, az) -> torch.Tensor:
    """Returns the device scalar alpha (for inspection; never read here)."""
    ts = [x[0], x[1], r[0], r[1], z[0], z[1], az[0], az[1]]
    _lib.check_cuda("lmr_step", ts)
    for pair in (r, z, az):
        if pair[0].shape != x[0].shape or pair[1].shape != x[1].shape:
            raise ValueError("lmr_step: x, r, z and Az must share shapes")
    nv, nm = x[0].numel(), x[1].numel()
    nb = lmr_partial_blocks(nv + nm)
    partials = torch.empty(2 * nb, dtype=torch.float64, device=x[0].device)
    alpha = torch.empty(1, dtype=torch.float32, device=x[0].device)
    _lib.library().call(
        "pfh_lmr_step", *[t.data_ptr() for t in ts], nv, nm, partials.data_ptr(),
        nb, alpha.data_ptr(), _lib.stream_handle())
    _lib.count_launch("lmr_step")
    return alpha


def lmr_step(x, r, z, az) -> None:
    """One LMR update of (x, r), in place."""
    if _lib.on_cpu(x[0]):
        lmr_step_plain(x, r, z, az)
    else:
        lmr_step_kernel(x, r, z, az)
