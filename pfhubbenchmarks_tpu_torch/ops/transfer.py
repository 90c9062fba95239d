"""Kernel D (``csrc/transfer.cu``): dyadic crossed-P1 grid transfers.

Prolongation, restriction (its exact transpose) and state injection between
a coarse grid and its 2x refinement, replacing the in-kernel transfer
matmuls of ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle``.
The plain versions are the strided-slice code of
``pfhubbenchmarks_tpu/solve/transfer.py`` (prolong, restrict,
inject_state), ported; the wrappers take them for CPU tensors only.

Dirichlet rows: prolongation and restriction take an optional 0/1 vertex
mask of their OUTPUT grid ([F, Yv, Xv] float32, nonzero on a BC row, from
fem/assembly.bc_mask). Restriction writes 0 on the coarse BC rows;
prolongation adds nothing on the fine BC rows (writes 0 there without
``out``). This is ``zero_bc_rows`` of ``pfhubbenchmarks_tpu/solve/gmg.py``
and the keep masks of ``ops/pallas_vcycle.py``'s chain kernels. The fine
residual's BC rows are not zeroed before restriction, there or here.
"""

from __future__ import annotations

import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib

_PROLONG, _RESTRICT, _INJECT = 0, 1, 2


def _check_dyadic(coarse: CrossedTriGrid, fine: CrossedTriGrid) -> None:
    if fine.ny != 2 * coarse.ny or fine.nx != 2 * coarse.nx:
        raise ValueError(f"not a dyadic pair: {fine.ny}x{fine.nx} / "
                         f"{coarse.ny}x{coarse.nx}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _zero_masked(v, mask):
    return v if mask is None else torch.where(mask != 0, torch.zeros_like(v), v)


def prolong_plain(wc, coarse: CrossedTriGrid, fine: CrossedTriGrid, mask=None):
    nyc, nxc = coarse.ny, coarse.nx
    vc = wc[0][:, : nyc + 1, : nxc + 1]
    mc = wc[1][:, :nyc, :nxc]
    F = vc.shape[0]
    vf = vc.new_zeros((F,) + fine.vshape)
    vf[:, 0: 2 * nyc + 1: 2, 0: 2 * nxc + 1: 2] = vc
    vf[:, 0: 2 * nyc + 1: 2, 1: 2 * nxc: 2] = 0.5 * (vc[:, :, :-1] + vc[:, :, 1:])
    vf[:, 1: 2 * nyc: 2, 0: 2 * nxc + 1: 2] = 0.5 * (vc[:, :-1, :] + vc[:, 1:, :])
    vf[:, 1: 2 * nyc: 2, 1: 2 * nxc: 2] = mc
    mf = vc.new_zeros((F,) + fine.mshape)
    mf[:, 0: 2 * nyc: 2, 0: 2 * nxc: 2] = 0.5 * (vc[:, :-1, :-1] + mc)
    mf[:, 0: 2 * nyc: 2, 1: 2 * nxc: 2] = 0.5 * (vc[:, :-1, 1:] + mc)
    mf[:, 1: 2 * nyc: 2, 0: 2 * nxc: 2] = 0.5 * (vc[:, 1:, :-1] + mc)
    mf[:, 1: 2 * nyc: 2, 1: 2 * nxc: 2] = 0.5 * (vc[:, 1:, 1:] + mc)
    return _zero_masked(vf, mask), mf


def restrict_plain(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid, mask=None):
    nyc, nxc = coarse.ny, coarse.nx
    vf = wf[0][:, : 2 * nyc + 1, : 2 * nxc + 1]
    mf = wf[1][:, : 2 * nyc, : 2 * nxc]
    vee = vf[:, 0::2, 0::2]
    veo = vf[:, 0::2, 1::2]
    voe = vf[:, 1::2, 0::2]
    voo = vf[:, 1::2, 1::2]
    m00 = mf[:, 0::2, 0::2]
    m01 = mf[:, 0::2, 1::2]
    m10 = mf[:, 1::2, 0::2]
    m11 = mf[:, 1::2, 1::2]
    vc = vee.clone()
    vc[:, :, :-1] += 0.5 * veo
    vc[:, :, 1:] += 0.5 * veo
    vc[:, :-1, :] += 0.5 * voe
    vc[:, 1:, :] += 0.5 * voe
    vc[:, :-1, :-1] += 0.5 * m00
    vc[:, :-1, 1:] += 0.5 * m01
    vc[:, 1:, :-1] += 0.5 * m10
    vc[:, 1:, 1:] += 0.5 * m11
    mc = voo + 0.5 * (m00 + m01 + m10 + m11)
    F = vc.shape[0]
    vc_p = vc.new_zeros((F,) + coarse.vshape)
    vc_p[:, : nyc + 1, : nxc + 1] = vc
    mc_p = vc.new_zeros((F,) + coarse.mshape)
    mc_p[:, :nyc, :nxc] = mc
    return _zero_masked(vc_p, mask), mc_p


def inject_plain(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid):
    nyc, nxc = coarse.ny, coarse.nx
    vf = wf[0][:, : 2 * nyc + 1, : 2 * nxc + 1]
    vc = vf[:, 0::2, 0::2]
    mc = vf[:, 1::2, 1::2]
    F = vc.shape[0]
    vc_p = vc.new_zeros((F,) + coarse.vshape)
    vc_p[:, : nyc + 1, : nxc + 1] = vc
    mc_p = vc.new_zeros((F,) + coarse.mshape)
    mc_p[:, :nyc, :nxc] = mc
    return vc_p, mc_p


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(op, src, dst, coarse, accumulate=False, mask=None):
    _lib.library().call(
        "pfh_transfer", op, src[0].data_ptr(), src[1].data_ptr(),
        dst[0].data_ptr(), dst[1].data_ptr(),
        None if mask is None else mask.data_ptr(), src[0].shape[0], coarse.ny,
        coarse.nx, int(accumulate), _lib.stream_handle())
    _lib.count_launch("transfer_dyadic")


def _check(name, src, src_grid, pairs, coarse, fine, mask=None, dst_grid=None):
    _check_dyadic(coarse, fine)
    for g in (coarse, fine):
        if g.periodic or g.pad_to != (1, 1):
            raise NotImplementedError(f"{name}: unpadded, non-periodic only")
    _lib.check_cuda(name, [t for p in pairs for t in p]
                    + ([mask] if mask is not None else []))
    F = src[0].shape[0]
    _lib.check_shapes(name, src, (F,) + src_grid.vshape, (F,) + src_grid.mshape)
    if mask is not None and tuple(mask.shape) != (F,) + dst_grid.vshape:
        raise ValueError(f"{name}: mask {tuple(mask.shape)}, expected "
                         f"{(F,) + dst_grid.vshape}")


def prolong_kernel(wc, coarse, fine, out=None, mask=None):
    """P wc; with ``out``, accumulate in place: out += P wc. ``mask``: the
    fine grid's BC rows, which get nothing."""
    pairs = [wc] + ([out] if out is not None else [])
    _check("prolong", wc, coarse, pairs, coarse, fine, mask, fine)
    F = wc[0].shape[0]
    if out is not None:
        _lib.check_shapes("prolong", out, (F,) + fine.vshape, (F,) + fine.mshape)
        _launch(_PROLONG, wc, out, coarse, accumulate=True, mask=mask)
        return out
    dst = (wc[0].new_empty((F,) + fine.vshape), wc[0].new_empty((F,) + fine.mshape))
    _launch(_PROLONG, wc, dst, coarse, mask=mask)
    return dst


def restrict_kernel(wf, coarse, fine, mask=None):
    """R wf; ``mask``: the coarse grid's BC rows, written as 0."""
    _check("restrict", wf, fine, [wf], coarse, fine, mask, coarse)
    F = wf[0].shape[0]
    dst = (wf[0].new_empty((F,) + coarse.vshape),
           wf[0].new_empty((F,) + coarse.mshape))
    _launch(_RESTRICT, wf, dst, coarse, mask=mask)
    return dst


def inject_kernel(wf, coarse, fine):
    _check("inject", wf, fine, [wf], coarse, fine)
    F = wf[0].shape[0]
    dst = (wf[0].new_empty((F,) + coarse.vshape),
           wf[0].new_empty((F,) + coarse.mshape))
    _launch(_INJECT, wf, dst, coarse)
    return dst


def prolong_accumulate_plain(wc, coarse, fine, out, mask=None):
    """out += P wc, in place, through the plain version."""
    for o, p in zip(out, prolong_plain(wc, coarse, fine, mask)):
        o.add_(p)
    return out


def prolong(wc, coarse: CrossedTriGrid, fine: CrossedTriGrid, out=None,
            mask=None):
    """Correction interpolation P wc; ``out`` (in place): out += P wc.
    ``mask``: the fine grid's Dirichlet rows, which get nothing."""
    if _lib.on_cpu(wc[0]):
        if out is None:
            return prolong_plain(wc, coarse, fine, mask)
        return prolong_accumulate_plain(wc, coarse, fine, out, mask)
    return prolong_kernel(wc, coarse, fine, out, mask)


def restrict(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid, mask=None):
    """Galerkin residual transfer R = P^T; ``mask``: the coarse grid's
    Dirichlet rows, written as 0."""
    if _lib.on_cpu(wf[0]):
        return restrict_plain(wf, coarse, fine, mask)
    return restrict_kernel(wf, coarse, fine, mask)


def inject(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """State injection (coarse nodes are fine nodes)."""
    if _lib.on_cpu(wf[0]):
        return inject_plain(wf, coarse, fine)
    return inject_kernel(wf, coarse, fine)
