"""The split V-cycle chains: every level's pre-smoothing and restriction
(``descend_chain``), and every level's prolongation, residual update and
post-smoothing (``ascend_chain``).

Replace ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:make_fused_descend_chain``
and ``make_fused_ascend_chain``, each one Pallas call on the TPU, with the
same signatures and outputs:

- ``descend_chain(b, w_levels, w0_levels, dt, pinvs) -> (xs, bs, bc)``: for
  each level l < K (K = len(grids) - 1), ``nu`` LMR sweeps from x = 0 on
  ``b_l``, then the Galerkin restriction of the smoothed residual with the
  coarse Dirichlet rows zeroed. ``xs`` are the smoothed iterates, ``bs`` the
  restricted right-hand sides of levels 1..K-1, ``bc`` the coarsest's.
- ``ascend_chain(bs, xs, xc, w_levels, w0_levels, dt, pinvs) -> z``: from the
  coarsest correction ``xc`` up through levels K-1..0: ``x = xs[l] + P xc``
  (nothing added on the fine Dirichlet rows), ``r = bs[l] - A x``, ``nu``
  LMR sweeps; ``bs[0]`` is the fine right-hand side.

``nu_fine`` (0: ``nu``) is the sweep count of level 0. ``field_groups``
are the sweeps' (ops/lmr.make_lmr_sweep_loop): the in-group block-Jacobi
planes and one LMR step length per group of a field-split cycle (BM2). On
the card each chain is a launch sequence of the port's kernels: per level a
sweep loop of the level J.v (kernel F for BM2, E for BM6 with its Dirichlet
mask, A for BM1), B (block-Jacobi) and C (LMR step), and D (transfers with
the Dirichlet masks), the form in which ``make_fused_vcycle`` was ported. ``.plain`` is the same sequence through
the plain versions; the wrapper takes it for CPU tensors only. A call of
``.kernel`` counts one ``descend_chain`` or ``ascend_chain`` call in
``_lib.CALLS``; its sweep loops and kernels count their own.
"""

from __future__ import annotations

import types

from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt

# the steps of a chain, as kernels or as plain versions; ``version`` names
# the attribute of a J.v or sweep loop
_KERNEL = types.SimpleNamespace(
    version="kernel", restrict=kt.restrict_kernel,
    prolong_acc=kt.prolong_kernel)
_PLAIN = types.SimpleNamespace(
    version="plain", restrict=kt.restrict_plain,
    prolong_acc=kt.prolong_accumulate_plain)


def _level_sweeps(jvs, nu, nu_fine, field_groups):
    """The sweep loop of each level above the coarsest."""
    return [lmr.make_lmr_sweep_loop(jvs[l], (nu_fine or nu) if l == 0 else nu,
                                    field_groups)
            for l in range(len(jvs) - 1)]


def _wrap(name, body, probe):
    """``probe(args)`` is the tensor whose device picks the version."""
    def kernel(*args):
        out = body(_KERNEL, *args)
        _lib.count_call(name)
        return out

    def plain(*args):
        return body(_PLAIN, *args)

    def chain(*args):
        return (plain if _lib.on_cpu(probe(args)) else kernel)(*args)

    chain.kernel, chain.plain = kernel, plain
    return chain


def make_descend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                       field_groups=None):
    """``jvs[l]``: level l's J.v (ops/fem_jvp.make_fem_jvp, with the level's
    Dirichlet rows); ``masks[l]``: level l's Dirichlet vertex mask tensor or
    None (fem/assembly.bc_mask)."""
    K = len(grids) - 1
    if K < 1:
        raise ValueError("a chain needs at least two levels")
    masks = masks or [None] * len(grids)
    sweeps = _level_sweeps(jvs, nu, nu_fine, field_groups)

    def body(o, b, w_levels, w0_levels, dt, pinvs):
        xs, bs = [], []
        for l in range(K):
            x = tuple(t.new_zeros(t.shape) for t in b)
            r = tuple(t.clone() for t in b)
            getattr(sweeps[l], o.version)(x, r, w_levels[l], w0_levels[l], dt,
                                          *pinvs[l])
            xs.append(x)
            b = o.restrict(r, grids[l + 1], grids[l], masks[l + 1])
            if l + 1 < K:
                bs.append(b)
        return xs, bs, b

    return _wrap("descend_chain", body, lambda a: a[0][0])


def make_ascend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                      field_groups=None):
    """Arguments as for ``make_descend_chain``."""
    K = len(grids) - 1
    if K < 1:
        raise ValueError("a chain needs at least two levels")
    masks = masks or [None] * len(grids)
    sweeps = _level_sweeps(jvs, nu, nu_fine, field_groups)

    def body(o, bs, xs, xc, w_levels, w0_levels, dt, pinvs):
        for l in range(K - 1, -1, -1):
            x = tuple(t.clone() for t in xs[l])
            o.prolong_acc(xc, grids[l + 1], grids[l], x, masks[l])
            r = getattr(jvs[l], o.version)(w_levels[l], w0_levels[l], dt, x,
                                           b=bs[l])
            getattr(sweeps[l], o.version)(x, r, w_levels[l], w0_levels[l], dt,
                                          *pinvs[l])
            xc = x
        return xc

    return _wrap("ascend_chain", body, lambda a: a[2][0])
