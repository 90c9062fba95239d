"""Kernel Q (``csrc/gridjvp_probe.cu``): BM3's J.v as a grid of row blocks,
each scattering into its own partial vertex slab, then a fold; and the
probe that runs it.

Replaces the launch of ``tools/probes/gridjvp_probe.py:167`` (TPU row 19):
bench3's 350^2 grid (F = 2, f32) as 7 row blocks of ``BR`` = 50 cell rows.
Each block evaluates its cells and writes its own slab of ``BR + 1`` vertex
rows (the TPU's ``BR + 8`` rows were Mosaic's alignment) and its cell rows;
the fold adds the slabs into the vertex plane. Cases: "a", the pointwise
tangent of BM3's physics; "b", identity physics (source z, flux grad z);
"c", the TPU probe's ``jax.jvp`` of the whole block assembly, which is case
a's function: CUDA has no in-kernel AD, so case c runs case a's body.

``make_gridjvp`` returns the slab step and the fold, each with its plain
version (the block's tangent assembled in f32 by the residual's einsums on
a ``BR`` x nx grid; the slabs added in block order), which the wrappers take
for CPU tensors only. Each wrapper counts one ``gridjvp_probe`` launch, the
fold too. ``probe`` is the TPU probe's path: the launch at bench3's shape,
its check against the full-grid J.v, and the device time per launch of Q,
its fold, kernel G and the tile kernel T12 at the same shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.assembly import (TabTensors, _context,
                                                    scatter_add,
                                                    slot_contributions)
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fem_jvp import (KernelPhys, params_head,
                                                  with_dt)

BR = 50
CASES = ("a", "b", "c")
TOL_F32 = dict(rtol=2e-4, atol=2e-5)   # the probe's check, as the JAX tests


def identity_tangent(ctx, tctx):
    """Case b's physics: source = z, flux = grad z (the probe's :105-108)."""
    del ctx
    return list(tctx.u), [tuple(d) for d in tctx.du]


def body_case(case: str) -> str:
    """The case whose body runs: c runs a's (the same function)."""
    if case not in CASES:
        raise ValueError(f"gridjvp: case {case!r}, not one of {CASES}")
    return "b" if case == "b" else "a"


def make_gridjvp(grid: CrossedTriGrid, phys: KernelPhys, *, device: torch.device | str,
                 br: int = BR):
    """``q(case, w, dt, z) -> (slabs, Jz_m)`` and ``q.fold(slabs) -> Jz_v``
    for the 2-field grid ``grid`` (unpadded, ny a multiple of ``br``);
    ``phys`` is bench3's ``kernel_phys()`` (ops/fem_jvp.KernelPhys, kind
    "ach": Q's tangent is BM3's). ``slabs`` is ``[2, nb (br + 1), nx + 1]``.
    ``q.jv`` is both, ``(Jz_v, Jz_m)``; ``q.plain``, ``q.kernel``,
    ``q.fold.plain`` and ``q.fold.kernel`` the versions."""
    if phys.kind == "acha":
        raise NotImplementedError("kernel Q at the anisotropic BM3's physics "
                                  "is not yet ported")
    if phys.kind != "ach":
        raise ValueError(f"kernel Q has BM3's physics only, not {phys.kind!r}")
    if grid.periodic or grid.pad_to != (1, 1):
        raise ValueError("gridjvp takes unpadded, non-periodic grids")
    if grid.ny % br:
        raise ValueError(f"gridjvp: ny {grid.ny} is not a multiple of {br}")
    F, nb, ny, nx = 2, grid.ny // br, grid.ny, grid.nx
    blk = dataclasses.replace(grid, ny=br, Ly=grid.hy * br)
    T = TabTensors.make(blk, torch.float32, device)
    head = params_head(grid, phys.constants, "gridjvp_probe")
    nq = grid.tab().nq
    slab_shape = (F, nb * (br + 1), nx + 1)

    def plain(case, w, dt, z):
        tangent = identity_tangent if body_case(case) == "b" else phys.tangent
        slabs, cells = [], []
        for i in range(nb):
            rv, rc = slice(i * br, i * br + br + 1), slice(i * br, (i + 1) * br)
            wb = (w[0][:, rv], w[1][:, rc])
            zb = (z[0][:, rv], z[1][:, rc])
            r_loc = slot_contributions(T, blk, tangent(
                _context(T, blk, wb, None, dt), _context(T, blk, zb, None, None)))
            sv, sm = scatter_add(r_loc, blk.vshape, blk.mshape, br, nx)
            slabs.append(sv)
            cells.append(sm)
        return torch.cat(slabs, dim=1), torch.cat(cells, dim=1)

    def kernel(case, w, dt, z):
        _lib.check_cuda("gridjvp_probe", [*w, *z])
        for pair in (w, z):
            _lib.check_shapes("gridjvp_probe", pair, (F,) + grid.vshape,
                              (F,) + grid.mshape)
        slabs = torch.empty(slab_shape, dtype=torch.float32, device=z[0].device)
        om = torch.empty_like(z[1])
        params = with_dt(head, dt, "gridjvp_probe")
        _lib.library().call(
            "pfh_gridjvp_probe", int(body_case(case) == "b"), params.ctypes.data,
            nq, w[0].data_ptr(), w[1].data_ptr(), z[0].data_ptr(),
            z[1].data_ptr(), slabs.data_ptr(), om.data_ptr(), ny, nx, br,
            _lib.stream_handle())
        _lib.count_launch("gridjvp_probe")
        return slabs, om

    def fold_plain(slabs):
        ov = torch.zeros((F,) + grid.vshape, dtype=slabs.dtype,
                         device=slabs.device)
        for i in range(nb):
            ov[:, i * br:i * br + br + 1] += slabs[:, i * (br + 1):(i + 1) * (br + 1)]
        return ov

    def fold_kernel(slabs):
        _lib.check_cuda("gridjvp_fold", [slabs])
        if tuple(slabs.shape) != slab_shape:
            raise ValueError(f"gridjvp_fold: slabs {tuple(slabs.shape)}, "
                             f"expected {slab_shape}")
        ov = torch.empty((F,) + grid.vshape, dtype=torch.float32,
                         device=slabs.device)
        _lib.library().call("pfh_gridjvp_fold", slabs.data_ptr(), ov.data_ptr(),
                            F, ny, nx, br, _lib.stream_handle())
        _lib.count_launch("gridjvp_probe")
        return ov

    def fold(slabs):
        return (fold_plain if _lib.on_cpu(slabs) else fold_kernel)(slabs)

    def q(case, w, dt, z):
        return (plain if _lib.on_cpu(z[0]) else kernel)(case, w, dt, z)

    def jv(case, w, dt, z):
        slabs, om = q(case, w, dt, z)
        return fold(slabs), om

    fold.plain, fold.kernel = fold_plain, fold_kernel
    q.plain, q.kernel, q.fold, q.jv = plain, kernel, fold, jv
    q.n_blocks = nb
    return q


def probe(case: str = "a", *, device: torch.device | str = "cuda",
          nx: int = 350, br: int = BR, seed: int = 0, timing: bool = True) -> dict:
    """The TPU probe's path at bench3's nx x nx (350^2: 7 blocks of 50
    rows): the IC as w (f32), seeded normal z, dt = 0.01; Q's launch and,
    for cases a and c, the folded result against the full-grid J.v of
    kernel G (its plain version on the CPU) and of ``torch.func.jvp`` of the
    f32 residual. With ``timing`` (on the card) the device microseconds per
    launch of Q, its fold, G and T12 at this shape."""
    from pfhubbenchmarks_tpu_torch.benchmarks import bench3
    from pfhubbenchmarks_tpu_torch.fem.assembly import make_residual

    device = torch.device(device)
    pb = bench3.make(nx=nx, ny=nx)
    g = pb.grid
    q = make_gridjvp(g, pb.kernel_phys(), device=device, br=br)
    w = tuple(a.float() for a in pb.initial_state(device))
    rng = np.random.default_rng(seed)
    z = tuple(torch.tensor(rng.normal(size=(2,) + s), dtype=torch.float32,
                           device=device) for s in (g.vshape, g.mshape))
    dt = 0.01
    slabs, om = q(case, w, dt, z)
    ov = q.fold(slabs)
    out = dict(case=case, body=body_case(case), blocks=q.n_blocks, br=br,
               out_m_norm=float(torch.linalg.norm(om)))
    jv_g = pb.kernel_jvp(g, device)
    if out["body"] == "a":
        res32 = make_residual(g, pb.terms, 2, device=device, dtype=torch.float32)
        refs = {"kernel G": jv_g(w, w, dt, z),
                "torch.func.jvp": torch.func.jvp(lambda u: res32(u, w, dt), (w,),
                                                 (z,))[1]}
        out["scale"] = max(float(refs["kernel G"][0].abs().max()), 1.0)
        for name, ref in refs.items():
            out[name] = dict(
                err_v=float((ov - ref[0]).abs().max()),
                err_m=float((om - ref[1]).abs().max()),
                ok=all(torch.allclose(a, b, rtol=TOL_F32["rtol"],
                                      atol=TOL_F32["atol"] * out["scale"])
                       for a, b in zip((ov, om), ref)))
    if timing and device.type == "cuda":
        jv_t12 = pb.kernel_jvp(g, device, form="seam")
        fns = {"Q": lambda: q.kernel(case, w, dt, z),
               "Q fold": lambda: q.fold.kernel(slabs),
               "G": lambda: jv_g.kernel(w, w, dt, z),
               "T12": lambda: jv_t12.kernel(w, w, dt, z)}
        out["device_us"] = {k: _lib.device_ms(f) * 1e3 for k, f in fns.items()}
    return out
