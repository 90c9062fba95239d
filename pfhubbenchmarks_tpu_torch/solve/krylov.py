"""Flexible restarted GMRES over pair vectors.

Counterpart of ``pfhubbenchmarks_tpu/solve/krylov.py:fgmres`` (PETSc
KSPFGMRES semantics): right preconditioning with stored directions
``Z_k = M(v_k)``, single-pass masked classical Gram-Schmidt, and
convergence decided on the TRUE residual ``||b - A x||`` recomputed at each
restart-cycle end; a cycle that improves it by < 10% is stalled and ends the
solve.

The loop is a Python loop. The vectors, the basis and its dots stay on the
device; the (m+1) x m Hessenberg least-squares problem (Givens rotations,
back substitution) runs on the host, which costs one device-to-host read
per iteration. It runs in the vectors' own precision (float32 for the
mixed-precision Krylov solve), as the JAX package does: on the stiff
large-dt systems the restart cycles stagnate, and whether a cycle improves
the true residual by 10% decides the Newton attempt; a float64 least-squares
solve there measurably changes that decision (bench1 at t = 9.5, dt = 3.2:
float64 kept improving for 240 iterations where the JAX package stalls at
150 and fails the attempt). ``gmres``, ``bicgstab`` and ``richardson`` are
not yet ported.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.solve import tree as tr


class KrylovResult(typing.NamedTuple):
    x: typing.Any
    iters: int
    converged: bool
    res_norm: float


def fgmres(matvec, b, Minv, *, restart=30, rtol=1e-5, atol=1e-50,
           maxiter=1000) -> KrylovResult:
    """Solve ``A x = b`` from x = 0 with ``matvec = A``; ``Minv`` may be
    nonlinear and may expose ``minv_matvec(v) -> (M v, A M v)`` (the
    V-cycle's exported pair, solve/gmg.py), which then replaces the separate
    outer matvec."""
    m = restart
    ft = np.float32 if b[0].dtype == torch.float32 else np.float64
    bnorm = ft(tr.norm(b).item())
    tol = max(ft(rtol) * bnorm, ft(atol))
    x = tr.zeros_like(b)
    minv_matvec = getattr(Minv, "minv_matvec", None)
    V = tr.basis_zeros(b, m + 1)
    Z = tr.basis_zeros(b, m)

    def init_cycle(x):
        r = tr.sub(b, matvec(x))
        beta = tr.norm(r)
        for Vl in V:
            Vl.zero_()
        tr.basis_set(V, 0, tr.scale(tr.safe_inv(beta), r))
        return ft(beta.item())

    beta = init_cycle(x)
    it = 0
    res = beta
    done = beta <= tol
    while not done and it < maxiter:
        cycle0 = beta
        H = np.zeros((m + 1, m), ft)
        cs = np.ones(m, ft)
        sn = np.zeros(m, ft)
        g = np.zeros(m + 1, ft)
        g[0] = beta
        k = 0
        while True:
            vk = tr.basis_get(V, k)
            if minv_matvec is not None:
                zk, w = minv_matvec(vk)
            else:
                zk = Minv(vk)
                w = matvec(zk)
            tr.basis_set(Z, k, zk)
            h = tr.basis_dots(V, w, k + 1)
            w = tr.sub(w, tr.basis_comb(V, h))
            hk1 = tr.norm(w)
            tr.basis_set(V, k + 1, tr.scale(tr.safe_inv(hk1), w))
            hcol = torch.cat([h, hk1[None]]).cpu().numpy().astype(ft)
            hk1_is_zero = hcol[k + 1] == 0
            # apply the previous k Givens rotations, then a new one
            for i in range(k):
                a, c = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * a + sn[i] * c
                hcol[i + 1] = -sn[i] * a + cs[i] * c
            hk, hkk = hcol[k], hcol[k + 1]
            denom = np.sqrt(hk * hk + hkk * hkk)
            cs[k] = hk / denom if denom > 0 else 1
            sn[k] = hkk / denom if denom > 0 else 0
            hcol[k] = denom
            H[: k + 1, k] = hcol[: k + 1]
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            res = abs(g[k + 1])
            it += 1
            if res <= tol or k + 1 >= m or it >= maxiter or hk1_is_zero:
                break
            k += 1
        # back substitution on the leading (k+1) x (k+1) triangle
        kk = k + 1
        y = np.zeros(kk, ft)
        for row in range(kk - 1, -1, -1):
            y[row] = (g[row] - H[row, row + 1: kk] @ y[row + 1:]) / H[row, row]
        yt = torch.as_tensor(y, dtype=b[0].dtype, device=b[0].device)
        x = tr.add(x, tr.basis_comb(Z, yt))
        beta = init_cycle(x)
        res = beta
        stalled = beta > 0.9 * cycle0
        done = beta <= tol or it >= maxiter or stalled
    return KrylovResult(x, it, bool(res <= tol), float(res))


SOLVERS = {"fgmres": fgmres}
