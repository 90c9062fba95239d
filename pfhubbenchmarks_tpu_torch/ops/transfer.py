"""Crossed-P1 grid transfers between the levels of a multigrid hierarchy.

Kernel D (``csrc/transfer.cu``): dyadic pairs (fine = 2 x coarse).
Prolongation, restriction (its exact transpose) and state injection,
replacing the in-kernel transfer matmuls of
``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_vcycle`` (``_LevelMats``).
The plain versions are the strided-slice code of
``pfhubbenchmarks_tpu/solve/transfer.py`` (prolong, restrict,
inject_state), ported.

Kernel H (``csrc/transfer_general.cu``): equal odd ratios R in {3, 5, 7}
(fine = R x coarse on both axes, bench3's 175 -> 35 -> 7). Prolongation is
exact P1 interpolation of the coarse crossed function (``prolong_general``
of ``solve/transfer.py:141``: per fine node, the five coarse slots of its
cell weighted by the class table of ``_p1_weights``, and 1-D edge
interpolation on the last fine vertex row and column); restriction is its
exact transpose (``restrict_general``, :203), written as a gather per coarse
node. They replace the SVD-separated matmuls of ``pallas_vcycle.py``'s
``_GenLevelMats`` (:97-140) inside ``make_fused_descend`` and
``make_fused_ascend``. The plain versions here sum in the kernel's order
with the same f32 weights, one rounded multiply and one rounded add per
term, so on the card the two agree to the bit. General injection stays
strided slicing (``inject_state_general``, computed outside any Pallas
kernel in the JAX package too).

Both kernels run one thread per (field, output node) over the per-node
bodies of ``csrc/transfer.cuh``; H's restriction stages the fine rows a
coarse row reads in shared memory first.

Dirichlet rows: prolongation and restriction take an optional 0/1 vertex
mask of their OUTPUT grid ([F, Yv, Xv] float32, nonzero on a BC row, from
fem/assembly.bc_mask). Restriction writes 0 on the coarse BC rows;
prolongation adds nothing on the fine BC rows (writes 0 there without
``out``). This is ``zero_bc_rows`` of ``pfhubbenchmarks_tpu/solve/gmg.py``
and the keep masks of ``ops/pallas_vcycle.py``'s level and chain kernels.
The fine residual's BC rows are not zeroed before restriction, there or
here.

``TransferPlan(coarse, fine, F, op, mask)`` is one transfer of one level
pair, built once where the level steps and the multigrid build are built:
every check and constant is fixed there, so a call on the card only checks
its tensors, allocates its output and launches. The functions below
(``prolong``, ``restrict``, ``inject``, ``transfer_ops(coarse, fine,
version)``, which picks D or H by the pair's ratio, and the ``*_kernel``
wrappers, which build a plan per call) serve the tests and callers off the
main path. Unequal per-axis ratios, even ratios other
than 2 and periodic pairs raise "not yet ported". The wrappers take the
plain versions for CPU tensors only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib

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


def _accumulate(p, out):
    """out += p in place (p itself without ``out``)."""
    if out is None:
        return p
    for o, q in zip(out, p):
        o.add_(q)
    return out


def prolong_accumulate_plain(wc, coarse, fine, out=None, mask=None):
    """out += P wc, in place, through the plain version (P wc without
    ``out``)."""
    return _accumulate(prolong_plain(wc, coarse, fine, mask), out)


# ---------------------------------------------------------------------------
# kernel H: equal odd ratios
# ---------------------------------------------------------------------------

GENERAL_RATIOS = (3, 5, 7)
_MAX_R = 7


def _p1_weights(s: float, t: float, Rx: int, Ry: int | None = None):
    """(w00, w10, w01, w11, wc) of the coarse crossed-P1 basis at cell-local
    point (s, t) in [0, Rx] x [0, Ry] (s along x): ``_p1_weights`` of
    ``pfhubbenchmarks_tpu/solve/transfer.py``. The four triangle regions'
    formulas agree on their shared edges, so ties are free."""
    if Ry is None:
        Ry = Rx
    sh, th = s / Rx, t / Ry
    ush, uth = 1.0 - sh, 1.0 - th
    if th <= sh and th <= ush:      # S
        return (1.0 - sh - th, sh - th, 0.0, 0.0, 2.0 * th)
    if th >= sh and th >= ush:      # N
        return (0.0, 0.0, 1.0 - sh - uth, sh - uth, 2.0 * uth)
    if sh <= th and sh <= uth:      # W
        return (1.0 - th - sh, 0.0, th - sh, 0.0, 2.0 * sh)
    return (0.0, 1.0 - th - ush, 0.0, th - ush, 2.0 * ush)  # E


@functools.cache
def class_tables(R: int):
    """The weights of prolongation with ratio R, built with numpy as
    ``prolong_general`` builds them (f64): ``wv``/``wm`` [R, R, 5] for the
    fine vertex and centre classes (py, px) of a coarse cell over its slots
    (SW, SE, NW, NE corners, centre), and ``frac`` = px / R for the last
    fine vertex row and column (weights 1 - frac and frac)."""
    wv = np.array([[_p1_weights(px, py, R) for px in range(R)]
                   for py in range(R)])
    wm = np.array([[_p1_weights(px + 0.5, py + 0.5, R) for px in range(R)]
                   for py in range(R)])
    return wv, wm, np.arange(R) / R


def _tables(R: int, dtype, device):
    """``class_tables(R)`` cast to the working dtype as the JAX code casts
    them, with 1 - frac rounded in that dtype."""
    wv, wm, frac = (torch.as_tensor(t, dtype=dtype, device=device)
                    for t in class_tables(R))
    return wv, wm, frac, 1.0 - frac


@functools.cache
def _general_params(R: int) -> np.ndarray:
    """The f32 tables as kernel H's parameter block (``GenWeights`` of
    csrc/transfer.cuh: wv, wm zero-padded to 7 x 7 classes, frac, 1 - frac),
    built once per ratio and uploaded once per device into the kernel's
    device memory (``TransferPlan``)."""
    wv, wm, frac, om = (t.numpy() for t in _tables(R, torch.float32, "cpu"))
    pv = np.zeros((_MAX_R, _MAX_R, 5), np.float32)
    pm = np.zeros((_MAX_R, _MAX_R, 5), np.float32)
    pv[:R, :R], pm[:R, :R] = wv, wm
    pf = np.zeros(_MAX_R, np.float32)
    po = np.zeros(_MAX_R, np.float32)
    pf[:R], po[:R] = frac, om
    return np.concatenate([pv.ravel(), pm.ravel(), pf, po])


def equal_ratio(coarse: CrossedTriGrid, fine: CrossedTriGrid) -> int:
    """The common ratio R of a nested, non-periodic pair with equal per-axis
    ratios; raises for any other pair."""
    rx, ry = fine.nx // coarse.nx, fine.ny // coarse.ny
    if fine.nx != rx * coarse.nx or fine.ny != ry * coarse.ny:
        raise ValueError(f"not nested: {fine.ny}x{fine.nx} / "
                         f"{coarse.ny}x{coarse.nx}")
    if fine.periodic or coarse.periodic or rx != ry or (
            rx != 2 and rx not in GENERAL_RATIOS):
        raise NotImplementedError(
            "transfers other than dyadic and equal odd-ratio (3, 5, 7) "
            "non-periodic ones are not yet ported to the PyTorch package "
            f"({fine.ny}x{fine.nx} -> {coarse.ny}x{coarse.nx})")
    return rx


def _general_ratio(coarse, fine) -> int:
    R = equal_ratio(coarse, fine)
    if R == 2:
        raise ValueError("a dyadic pair takes kernel D")
    return R


def prolong_general_plain(wc, coarse: CrossedTriGrid, fine: CrossedTriGrid,
                          mask=None):
    R = _general_ratio(coarse, fine)
    nyc, nxc = coarse.ny, coarse.nx
    vc = wc[0][:, : nyc + 1, : nxc + 1]
    mc = wc[1][:, :nyc, :nxc]
    F, dt_, dev = vc.shape[0], vc.dtype, vc.device
    wv, wm, frac, om = _tables(R, dt_, dev)
    slots = (vc[:, :-1, :-1], vc[:, :-1, 1:], vc[:, 1:, :-1], vc[:, 1:, 1:], mc)

    def classes(W):
        """[R, R, 5] weights -> the [F, R nyc, R nxc] block, each class
        summed over the slots in order (one rounded mul and add per term)."""
        acc = W[:, :, 0, None, None, None] * slots[0]
        for k in range(1, 5):
            acc = acc + W[:, :, k, None, None, None] * slots[k]
        return acc.permute(2, 3, 0, 4, 1).reshape(F, R * nyc, R * nxc)

    vf = vc.new_zeros((F,) + fine.vshape)
    vf[:, : R * nyc, : R * nxc] = classes(wv)
    top, right = vc[:, nyc, :], vc[:, :, nxc]
    vf[:, R * nyc, : R * nxc] = (om * top[:, :-1, None]
                                 + frac * top[:, 1:, None]).reshape(F, -1)
    vf[:, : R * nyc, R * nxc] = (om * right[:, :-1, None]
                                 + frac * right[:, 1:, None]).reshape(F, -1)
    vf[:, R * nyc, R * nxc] = vc[:, nyc, nxc]
    mf = vc.new_zeros((F,) + fine.mshape)
    mf[:, : R * nyc, : R * nxc] = classes(wm)
    return _zero_masked(vf, mask), mf


def prolong_general_accumulate_plain(wc, coarse, fine, out=None, mask=None):
    """out += P wc, in place, through the plain version (P wc without
    ``out``)."""
    return _accumulate(prolong_general_plain(wc, coarse, fine, mask), out)


def restrict_general_plain(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid,
                           mask=None):
    """P^T wf as kernel H gathers it: per coarse vertex, its cells as slot
    SW, SE, NW, NE (each: the fine vertex classes, then the centre classes,
    (py, px) row-major), then the last fine row's and column's 1-D weights
    (1 - frac, then frac) and the corner; per coarse centre, its cell's
    classes. A cell outside the grid adds exact zeros here and nothing in
    the kernel."""
    R = _general_ratio(coarse, fine)
    nyc, nxc = coarse.ny, coarse.nx
    vf, mf = wf[0], wf[1]
    F, dt_, dev = vf.shape[0], vf.dtype, vf.device
    wv, wm, frac, om = _tables(R, dt_, dev)

    def cells(a):
        """[F, R nyc(+1), R nxc(+1)] -> per-cell blocks [F, nyc + 2, nxc + 2,
        R, R] with a ring of zero cells."""
        blk = a[:, : R * nyc, : R * nxc].reshape(F, nyc, R, nxc, R)
        blk = blk.permute(0, 1, 3, 2, 4)
        return torch.nn.functional.pad(blk, (0, 0, 0, 0, 1, 1, 1, 1))

    cv, cm = cells(vf), cells(mf)
    vc = vf.new_zeros((F, nyc + 1, nxc + 1))
    # slot k reads cell (I + dy, J + dx) of coarse vertex (I, J)
    for k, (dy, dx) in enumerate(((0, 0), (0, -1), (-1, 0), (-1, -1))):
        for W, c in ((wv, cv), (wm, cm)):
            blk = c[:, 1 + dy: 2 + dy + nyc, 1 + dx: 2 + dx + nxc]
            for py in range(R):
                for px in range(R):
                    vc = vc + W[py, px, k] * blk[..., py, px]
    pad1 = torch.nn.functional.pad
    top = vf[:, R * nyc, : R * nxc].reshape(F, nxc, R)
    right = vf[:, : R * nyc, R * nxc].reshape(F, nyc, R)
    for edge, at in ((top, (slice(None), nyc, slice(None))),
                     (right, (slice(None), slice(None), nxc))):
        e0, e1 = pad1(edge, (0, 0, 0, 1)), pad1(edge, (0, 0, 1, 0))
        acc = vc[at]
        for p in range(R):
            acc = acc + om[p] * e0[..., p]
        for p in range(R):
            acc = acc + frac[p] * e1[..., p]
        vc = vc.clone()
        vc[at] = acc
    vc[:, nyc, nxc] = vc[:, nyc, nxc] + vf[:, R * nyc, R * nxc]
    mc = vf.new_zeros((F, nyc, nxc))
    for W, c in ((wv, cv), (wm, cm)):
        blk = c[:, 1: 1 + nyc, 1: 1 + nxc]
        for py in range(R):
            for px in range(R):
                mc = mc + W[py, px, 4] * blk[..., py, px]
    vc_p = vf.new_zeros((F,) + coarse.vshape)
    vc_p[:, : nyc + 1, : nxc + 1] = vc
    mc_p = vf.new_zeros((F,) + coarse.mshape)
    mc_p[:, :nyc, :nxc] = mc
    return _zero_masked(vc_p, mask), mc_p


def inject_general(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """State injection for an equal odd ratio: coarse vertices are fine
    vertices, a coarse centre is the fine centre at offset (R-1)/2 in its
    cell (``inject_state_general``). Strided slicing on any device."""
    R = _general_ratio(coarse, fine)
    nyc, nxc, o = coarse.ny, coarse.nx, (R - 1) // 2
    vc = wf[0][:, : R * nyc + 1: R, : R * nxc + 1: R]
    mc = wf[1][:, o: R * nyc: R, o: R * nxc: R]
    F = vc.shape[0]
    vc_p = vc.new_zeros((F,) + coarse.vshape)
    vc_p[:, : nyc + 1, : nxc + 1] = vc
    mc_p = vc.new_zeros((F,) + coarse.mshape)
    mc_p[:, :nyc, :nxc] = mc
    return vc_p, mc_p


# ---------------------------------------------------------------------------
# launch plans: kernel D for a dyadic pair, H for an equal odd ratio
# ---------------------------------------------------------------------------

_OPS = {"prolong": 0, "restrict": 1, "inject": 2}
# (library path, device index, R): H's class tables are in R's slot
_WEIGHTS_ON: set[tuple[str, int, int]] = set()


def _upload_general_weights(lib, R: int, dev: int) -> None:
    """Kernel H's class tables for ratio R into R's slot in the kernel's
    device memory on CUDA device ``dev``, once per library, device and R."""
    key = (str(lib.path), dev, R)
    if key in _WEIGHTS_ON:
        return
    params = _general_params(R)
    if params.size != lib.lib.pfh_transfer_general_param_floats():
        raise RuntimeError("transfer_general: parameter block does not match "
                           "the kernel's GenWeights layout")
    with torch.cuda.device(dev):
        lib.call("pfh_transfer_general_upload", R, params.ctypes.data)
    _WEIGHTS_ON.add(key)


class TransferPlan:
    """One transfer of one level pair for F fields, fixed when it is built:
    ``op`` "prolong" (coarse -> fine; with ``out``, out += P wc in place),
    "restrict" (fine -> coarse, R = P^T) or "inject" (state injection), and
    ``mask`` the Dirichlet vertex mask of the OUTPUT grid or None (prolong
    and restrict only).

    Construction picks kernel D (dyadic) or H (equal odd ratio) by
    ``equal_ratio``, checks the grids (unpadded, non-periodic) and the mask,
    and fixes the shapes and the kernel's ints; odd-ratio injection is
    strided slicing on any device (``inject_general``). ``plan(src, out=None)``
    runs the plain version for CPU tensors and the kernel otherwise:
    ``.kernel`` checks the tensors (CUDA, float32, contiguous, the fixed
    shapes, one device) and raises on anything else, allocates the output
    where there is one, and makes one ctypes call on the current stream;
    nothing is built before the first CUDA call. ``.plain`` is the plain
    version."""

    def __init__(self, coarse: CrossedTriGrid, fine: CrossedTriGrid, F: int,
                 op: str, mask: torch.Tensor | None = None):
        if op not in _OPS:
            raise ValueError(f"transfer op {op!r}: one of {sorted(_OPS)}")
        R = equal_ratio(coarse, fine)
        for g in (coarse, fine):
            if g.periodic or g.pad_to != (1, 1):
                raise NotImplementedError(f"{op}: unpadded, non-periodic "
                                          "grids only")
        src, dst = (coarse, fine) if op == "prolong" else (fine, coarse)
        self.coarse, self.fine, self.F, self.op, self.R = coarse, fine, F, op, R
        self.name = op if R == 2 else f"{op}_general"
        self.src_shapes = tuple(torch.Size((F,) + s)
                                for s in (src.vshape, src.mshape))
        self.dst_shapes = tuple(torch.Size((F,) + s)
                                for s in (dst.vshape, dst.mshape))
        if mask is not None:
            if op == "inject":
                raise ValueError("inject: takes no mask")
            if mask.shape != self.dst_shapes[0]:
                raise ValueError(f"{self.name}: mask {tuple(mask.shape)}, "
                                 f"expected {tuple(self.dst_shapes[0])}")
            if mask.is_cuda and not (mask.dtype == torch.float32
                                     and mask.is_contiguous()):
                raise ValueError(f"{self.name}: a CUDA mask must be "
                                 "contiguous float32")
        self.mask = mask
        self._mask_dev = None if mask is None else mask.get_device()
        self._mask_ptr = None if mask is None or not mask.is_cuda else mask.data_ptr()
        self.kernel_name = "transfer_dyadic" if R == 2 else "transfer_general"
        self._symbol = "pfh_transfer" if R == 2 else "pfh_transfer_general"
        self._head = (_OPS[op],) if R == 2 else (_OPS[op], R)
        self._ints = (F, coarse.ny, coarse.nx)
        self._fn, self._dev = None, None
        if op == "inject" and R != 2:
            self.kernel = self.plain

    def __call__(self, src, out=None):
        return (self.plain if src[0].is_cpu else self.kernel)(src, out)

    def plain(self, src, out=None):
        c, f = self.coarse, self.fine
        if self.op == "prolong":
            return (prolong_accumulate_plain if self.R == 2 else
                    prolong_general_accumulate_plain)(src, c, f, out, self.mask)
        if out is not None:
            raise ValueError(f"{self.name}: takes no out")
        if self.op == "restrict":
            return (restrict_plain if self.R == 2 else
                    restrict_general_plain)(src, c, f, self.mask)
        return (inject_plain if self.R == 2 else inject_general)(src, c, f)

    def check(self, src, out=None) -> int:
        """The CUDA device index of ``src`` (and ``out``); raises unless
        every tensor is a contiguous float32 CUDA tensor of the fixed shape
        on that device, with the mask."""
        dev = src[0].get_device()
        pairs = ((src, self.src_shapes),)
        if out is not None:
            if self.op != "prolong":
                raise ValueError(f"{self.name}: takes no out")
            pairs += ((out, self.dst_shapes),)
        for pair, shapes in pairs:
            for t, shape in zip(pair, shapes):
                if not (t.is_cuda and t.dtype == torch.float32
                        and t.is_contiguous() and t.shape == shape
                        and t.get_device() == dev):
                    self._refuse(t, shape, dev)
        if self._mask_dev is not None and self._mask_dev != dev:
            raise ValueError(f"{self.name}: mask on {self.mask.device}, "
                             f"tensors on cuda:{dev}")
        return dev

    def _refuse(self, t, shape, dev):
        if not t.is_cuda:
            raise ValueError(f"{self.name}: kernel needs CUDA tensors, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{self.name}: dtype {t.dtype}, kernel takes "
                             "torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{self.name}: non-contiguous tensor")
        if t.shape != shape:
            raise ValueError(f"{self.name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        raise ValueError(f"{self.name}: tensors on {t.device} and cuda:{dev}")

    def _bind(self, dev: int):
        """The C launcher, resolved once; H's tables on device ``dev``."""
        lib = _lib.library()
        if self.R != 2:
            _upload_general_weights(lib, self.R, dev)
        self._fn, self._dev = getattr(lib.lib, self._symbol), dev
        return self._fn

    def kernel(self, src, out=None):
        dev = self.check(src, out)
        accumulate = out is not None
        if not accumulate:
            out = (src[0].new_empty(self.dst_shapes[0]),
                   src[0].new_empty(self.dst_shapes[1]))
        fn = self._fn if dev == self._dev else self._bind(dev)
        err = fn(*self._head, src[0].data_ptr(), src[1].data_ptr(),
                 out[0].data_ptr(), out[1].data_ptr(), self._mask_ptr,
                 *self._ints, int(accumulate), _lib.stream_handle())
        if err != 0:
            raise RuntimeError(f"{self._symbol}: CUDA error {err} at launch")
        _lib.count_launch(self.kernel_name)
        return out


def prolong_kernel(wc, coarse, fine, out=None, mask=None):
    """P wc by kernel D; with ``out``, accumulate in place: out += P wc.
    ``mask``: the fine grid's BC rows, which get nothing."""
    _check_dyadic(coarse, fine)
    return TransferPlan(coarse, fine, wc[0].shape[0], "prolong",
                        mask).kernel(wc, out)


def restrict_kernel(wf, coarse, fine, mask=None):
    """R wf by kernel D; ``mask``: the coarse grid's BC rows, written as 0."""
    _check_dyadic(coarse, fine)
    return TransferPlan(coarse, fine, wf[0].shape[0], "restrict",
                        mask).kernel(wf)


def inject_kernel(wf, coarse, fine):
    _check_dyadic(coarse, fine)
    return TransferPlan(coarse, fine, wf[0].shape[0], "inject").kernel(wf)


def prolong_general_kernel(wc, coarse, fine, out=None, mask=None):
    """P wc by kernel H for an equal odd ratio; with ``out``, out += P wc in
    place. ``mask``: the fine grid's BC rows, which get nothing."""
    _general_ratio(coarse, fine)
    return TransferPlan(coarse, fine, wc[0].shape[0], "prolong",
                        mask).kernel(wc, out)


def restrict_general_kernel(wf, coarse, fine, mask=None):
    """P^T wf by kernel H for an equal odd ratio; ``mask``: the coarse
    grid's BC rows, written as 0."""
    _general_ratio(coarse, fine)
    return TransferPlan(coarse, fine, wf[0].shape[0], "restrict",
                        mask).kernel(wf)


# ---------------------------------------------------------------------------
# by ratio: D for dyadic pairs, H for equal odd ratios
# ---------------------------------------------------------------------------

# (version, dyadic) -> (restrict, prolong); the prolongation
# prolong(wc, coarse, fine, out, mask) accumulates into ``out`` if given
_VERSIONS = {
    ("kernel", True): (restrict_kernel, prolong_kernel),
    ("kernel", False): (restrict_general_kernel, prolong_general_kernel),
    ("plain", True): (restrict_plain, prolong_accumulate_plain),
    ("plain", False): (restrict_general_plain,
                       prolong_general_accumulate_plain),
}


def transfer_ops(coarse: CrossedTriGrid, fine: CrossedTriGrid, version: str):
    """(restrict, prolong) of the pair, as kernels (``version='kernel'``) or
    plain versions: kernel D for a dyadic pair, H for an equal odd ratio."""
    return _VERSIONS[(version, equal_ratio(coarse, fine) == 2)]


def _version(t: torch.Tensor) -> str:
    return "plain" if _lib.on_cpu(t) else "kernel"


def prolong(wc, coarse: CrossedTriGrid, fine: CrossedTriGrid, out=None,
            mask=None):
    """Correction interpolation P wc; ``out`` (in place): out += P wc.
    ``mask``: the fine grid's Dirichlet rows, which get nothing."""
    return transfer_ops(coarse, fine, _version(wc[0]))[1](wc, coarse, fine,
                                                          out, mask)


def restrict(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid, mask=None):
    """Galerkin residual transfer R = P^T; ``mask``: the coarse grid's
    Dirichlet rows, written as 0."""
    return transfer_ops(coarse, fine, _version(wf[0]))[0](wf, coarse, fine,
                                                          mask)


def inject(wf, coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """State injection (coarse nodes are fine nodes): kernel D for a dyadic
    pair, strided slicing for an equal odd ratio."""
    if equal_ratio(coarse, fine) != 2:
        return inject_general(wf, coarse, fine)
    if _lib.on_cpu(wf[0]):
        return inject_plain(wf, coarse, fine)
    return inject_kernel(wf, coarse, fine)
