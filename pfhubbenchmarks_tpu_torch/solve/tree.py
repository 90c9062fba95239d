"""Pair linear algebra for matrix-free Krylov methods.

Counterpart of ``pfhubbenchmarks_tpu/solve/tree.py``. Solution states are
pairs ``(v, m)`` (vertex grid + centre grid per field), so Krylov vectors
stay pairs: dots reduce per leaf and sum. A Krylov basis is a pair whose
leaves carry a leading slot axis.

Dot products accumulate in float64 and round once to the vectors' dtype.
An f32 sum over the ~40k entries of a BM1 state depends on the library's
summation order (CPU BLAS, cuBLAS and XLA all differ), and the restart
cycles of a stiff large-dt FGMRES solve amplify that: from the JAX run's
state at bench1's t = 9.5 with dt = 3.2, f32 torch dots kept FGMRES
improving for 270 iterations, while f64-accumulated dots, the JAX package
and 4 of 5 runs with the right-hand side perturbed at 1e-7..1e-5 stall by
180 iterations and fail the attempt, as the reference time grid does.
"""

from __future__ import annotations

import torch


def vdot(a, b):
    acc = sum((torch.dot(x.reshape(-1).double(), y.reshape(-1).double())
               for x, y in zip(a, b)))
    return acc.to(a[0].dtype)


def norm(a):
    return torch.sqrt(vdot(a, a))


def add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def scale(s, a):
    return tuple(s * x for x in a)


def axpy(s, x, y):
    """y + s * x."""
    return tuple(yl + s * xl for xl, yl in zip(x, y))


def zeros_like(a):
    return tuple(torch.zeros_like(x) for x in a)


def neg(a):
    return tuple(-x for x in a)


def cast(a, dtype):
    return tuple(x.to(dtype) for x in a)


# ---- stacked Krylov basis: each leaf gains a leading slot axis ----

def basis_zeros(proto, m: int):
    return tuple(x.new_zeros((m,) + x.shape) for x in proto)


def basis_set(V, k: int, v) -> None:
    """V[k] = v, in place (the basis is preallocated per restart cycle)."""
    for Vl, vl in zip(V, v):
        Vl[k].copy_(vl)


def basis_get(V, k: int):
    return tuple(Vl[k] for Vl in V)


def basis_dots(V, w, n: int):
    """[n] vector of <V_i, w> for the first n slots (one matvec per leaf)."""
    acc = sum((Vl[:n].reshape(n, -1).double() @ wl.reshape(-1).double()
               for Vl, wl in zip(V, w)))
    return acc.to(w[0].dtype)


def basis_comb(V, y):
    """sum_i y_i V_i over the first len(y) slots."""
    n = y.shape[0]
    return tuple((y @ Vl[:n].reshape(n, -1)).reshape(Vl.shape[1:]) for Vl in V)


def safe_inv(x):
    """1/x for x > 0, else 0 (a tensor)."""
    return torch.where(x > 0, 1.0 / torch.where(x > 0, x, 1.0),
                       torch.zeros_like(x))
