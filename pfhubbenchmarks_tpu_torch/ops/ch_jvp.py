"""Kernel A (``csrc/ch_jvp.cu``): J.v of BM1's Cahn-Hilliard weak form.

Replaces ``pfhubbenchmarks_tpu/ops/pallas_residual.py:make_pallas_jvp`` and
the in-kernel A.z of ``ops/pallas_vcycle.py:make_fused_vcycle``. One kernel
serves every quadrature rule: the tabulation of the grid (ffc3 for the outer
matvec and the exported pair, dunavant2 on the multigrid levels) and the
physics constants are launch arguments.

The plain version beside it is ``torch.func.jvp`` of the f32 residual
(fem/assembly.make_residual). The wrapper takes the plain version for CPU
tensors only; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib

_MAX_Q = 4
# physics constants the kernel takes, in its parameter order
CONSTANTS = ("M", "kappa", "rho_s", "c_alpha", "c_beta")


def pack_tabulation(grid: CrossedTriGrid) -> np.ndarray:
    """Bq, Gs, WB, WGx, WGy as the kernel's float32 parameter block
    (quadrature axis zero-padded to 4 points)."""
    tab = grid.tab()
    nq = tab.nq
    if nq > _MAX_Q:
        raise ValueError(f"ch_jvp takes at most {_MAX_Q} points, rule has {nq}")

    def padq(a):  # [4, nq, 5] -> [4, 4, 5]
        out = np.zeros((4, _MAX_Q, 5))
        out[:, :nq] = a
        return out

    WB = tab.wq[:, :, None] * tab.Bq
    WGx = tab.wq[:, :, None] * tab.Gs[:, None, :, 0]
    WGy = tab.wq[:, :, None] * tab.Gs[:, None, :, 1]
    parts = [padq(tab.Bq), tab.Gs, padq(WB), padq(WGx), padq(WGy)]
    return np.concatenate([p.reshape(-1) for p in parts]).astype(np.float32)


def make_ch_jvp(grid: CrossedTriGrid, terms, constants: dict, *,
                device: torch.device | str):
    """Returns ``jv(w, w0, dt, v, b=None)``: ``J(w, w0, dt) v``, or
    ``b - J v`` when ``b`` is given, as an f32 pair. ``dt`` is a Python
    float. ``jv.plain`` and ``jv.kernel`` are the two versions."""
    if grid.periodic or grid.pad_to != (1, 1):
        raise NotImplementedError("ch_jvp takes unpadded, non-periodic grids")
    residual = make_residual(grid, terms, 2, device=device, dtype=torch.float32)
    tab_block = pack_tabulation(grid)
    const = np.array([constants[k] for k in CONSTANTS], np.float32)
    nq = grid.tab().nq
    vshape, mshape = (2,) + grid.vshape, (2,) + grid.mshape

    def plain(w, w0, dt, v, b=None):
        _, jv_ = torch.func.jvp(lambda u: residual(u, w0, dt), (w,), (v,))
        return jv_ if b is None else (b[0] - jv_[0], b[1] - jv_[1])

    def kernel(w, w0, dt, v, b=None):
        del w0  # the CH tangent does not read the previous time level
        ts = [*w, *v] + ([*b] if b is not None else [])
        _lib.check_cuda("ch_jvp", ts)
        for pair in (w, v) if b is None else (w, v, b):
            _lib.check_shapes("ch_jvp", pair, vshape, mshape)
        out = (torch.empty_like(v[0]), torch.empty_like(v[1]))
        params = np.concatenate([tab_block, const,
                                 np.array([dt], np.float32)])
        lib = _lib.library()
        if params.size != lib.lib.pfh_ch_jvp_param_floats():
            raise RuntimeError("ch_jvp: parameter block does not match the "
                               "kernel's CHParams layout")
        bv, bm = (None, None) if b is None else (b[0].data_ptr(), b[1].data_ptr())
        lib.call("pfh_ch_jvp", params.ctypes.data, nq,
                 w[0].data_ptr(), w[1].data_ptr(), v[0].data_ptr(),
                 v[1].data_ptr(), bv, bm, out[0].data_ptr(), out[1].data_ptr(),
                 grid.ny, grid.nx, _lib.stream_handle())
        _lib.count_launch("ch_jvp")
        return out

    def jv(w, w0, dt, v, b=None):
        return (plain if _lib.on_cpu(v[0]) else kernel)(w, w0, dt, v, b)

    jv.plain = plain
    jv.kernel = kernel
    return jv
