"""The V-cycle's level steps and the chains built from them.

The level steps replace ``pfhubbenchmarks_tpu/ops/pallas_vcycle.py:
make_fused_descend`` and ``make_fused_ascend`` (one Pallas call per level
pair on the TPU, ``fuse_vcycle='split_levels'``), with the same signatures
and outputs:

- ``descend(b, w, w0, dt, pinv) -> (x, bc)``: ``nu`` LMR sweeps from x = 0
  on ``b`` at the fine level, then the Galerkin restriction of the smoothed
  residual with the coarse Dirichlet rows zeroed.
- ``ascend(b, x, xc, w, w0, dt, pinv) -> z``: ``x + P xc`` (nothing added
  on the fine Dirichlet rows), ``r = b - A x`` in one J.v launch, ``nu``
  LMR sweeps.

The chains replace ``make_fused_descend_chain`` and ``make_fused_ascend_chain``
(``fuse_vcycle='split_chain'``, one Pallas call each) and loop over the
level steps:

- ``descend_chain(b, w_levels, w0_levels, dt, pinvs) -> (xs, bs, bc)``: the
  descent of every level l < K (K = len(grids) - 1); ``xs`` are the smoothed
  iterates, ``bs`` the restricted right-hand sides of levels 1..K-1, ``bc``
  the coarsest's.
- ``ascend_chain(bs, xs, xc, w_levels, w0_levels, dt, pinvs) -> z``: the
  ascent from the coarsest correction ``xc`` up through levels K-1..0;
  ``bs[0]`` is the fine right-hand side.

The JAX package's ``split_levels`` recursion (``solve/gmg.py:663-675``) and
``split_chain`` (:654-662) are the same arithmetic in two launch
structures; the port runs the chains, so both TPU kernel pairs are these
level steps.

``nu_fine`` (0: ``nu``) is the sweep count of level 0. ``field_groups``
are the sweeps' (ops/lmr.make_lmr_sweep_loop): the in-group block-Jacobi
planes and one LMR step length per group of a field-split cycle (BM2). On
the card a level step is a launch sequence of the port's kernels: the sweep
loop, one launch of kernel L over the level J.v's body (kernel G's physics
for BM3, F's for BM2, E's with its Dirichlet mask for BM6, A's for BM1), or
on a level routed to the tile kernels the tiled sweep loop of TS and C
(ops/lmr.make_level_sweep_loop picks by the level's J.v); the level J.v
(T12 on a tiled level) for the ascent's residual; and the pair's transfer,
a plan built once with the step (ops/transfer.TransferPlan, for the level
J.v's ``n_fields``): kernel D for a dyadic pair, H for an equal odd ratio,
with the Dirichlet masks. ``.plain`` is the same sequence
through the plain versions; the wrapper takes it for CPU tensors only. A
call of ``.kernel`` counts one ``descend_level``, ``ascend_level``,
``descend_chain`` or ``ascend_chain`` call in ``_lib.CALLS``; the steps,
sweep loops and kernels inside count their own.
"""

from __future__ import annotations

from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.ops import transfer as kt


def _wrap(name, body, probe):
    """``body(version, *args)``; ``probe(args)`` is the tensor whose device
    picks the version."""
    def kernel(*args):
        out = body("kernel", *args)
        _lib.count_call(name)
        return out

    def plain(*args):
        return body("plain", *args)

    def step(*args):
        return (plain if _lib.on_cpu(probe(args)) else kernel)(*args)

    step.kernel, step.plain = kernel, plain
    return step


def make_descend_level(fine, coarse, jv, *, nu: int, mask_coarse=None,
                       field_groups=None):
    """``jv``: the fine level's J.v (ops/fem_jvp.make_fem_jvp or
    ops/fem_tile.make_tile_jvp, with its Dirichlet rows and ``n_fields``);
    ``mask_coarse``: the coarse grid's Dirichlet vertex mask tensor or None
    (fem/assembly.bc_mask)."""
    sweep = lmr.make_level_sweep_loop(jv, nu, field_groups)
    restrict = kt.TransferPlan(coarse, fine, jv.n_fields, "restrict",
                               mask_coarse)

    def body(version, b, w, w0, dt, pinv):
        x = tuple(t.new_zeros(t.shape) for t in b)
        r = tuple(t.clone() for t in b)
        getattr(sweep, version)(x, r, w, w0, dt, *pinv)
        return x, getattr(restrict, version)(r)

    return _wrap("descend_level", body, lambda a: a[0][0])


def make_ascend_level(fine, coarse, jv, *, nu: int, mask_fine=None,
                      field_groups=None):
    """``mask_fine``: the fine grid's Dirichlet vertex mask tensor or None;
    the rest as for ``make_descend_level``."""
    sweep = lmr.make_level_sweep_loop(jv, nu, field_groups)
    prolong = kt.TransferPlan(coarse, fine, jv.n_fields, "prolong", mask_fine)

    def body(version, b, x, xc, w, w0, dt, pinv):
        x = tuple(t.clone() for t in x)
        getattr(prolong, version)(xc, x)
        r = getattr(jv, version)(w, w0, dt, x, b=b)
        getattr(sweep, version)(x, r, w, w0, dt, *pinv)
        return x

    return _wrap("ascend_level", body, lambda a: a[0][0])


def _level_args(grids, masks, nu, nu_fine):
    """Per level pair l: the sweep count and the (fine, coarse) masks."""
    if len(grids) < 2:
        raise ValueError("a chain needs at least two levels")
    masks = masks or [None] * len(grids)
    return [((nu_fine or nu) if l == 0 else nu, masks[l], masks[l + 1])
            for l in range(len(grids) - 1)]


def make_descend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                       field_groups=None):
    """``jvs[l]``: level l's J.v; ``masks[l]``: level l's Dirichlet vertex
    mask tensor or None."""
    steps = [make_descend_level(grids[l], grids[l + 1], jvs[l], nu=n,
                                mask_coarse=mc, field_groups=field_groups)
             for l, (n, _, mc) in enumerate(_level_args(grids, masks, nu,
                                                        nu_fine))]
    K = len(steps)

    def body(version, b, w_levels, w0_levels, dt, pinvs):
        xs, bs = [], []
        for l in range(K):
            x, b = getattr(steps[l], version)(b, w_levels[l], w0_levels[l], dt,
                                              pinvs[l])
            xs.append(x)
            if l + 1 < K:
                bs.append(b)
        return xs, bs, b

    return _wrap("descend_chain", body, lambda a: a[0][0])


def make_ascend_chain(grids, jvs, *, nu: int, nu_fine: int = 0, masks=None,
                      field_groups=None):
    """Arguments as for ``make_descend_chain``."""
    steps = [make_ascend_level(grids[l], grids[l + 1], jvs[l], nu=n,
                               mask_fine=mf, field_groups=field_groups)
             for l, (n, mf, _) in enumerate(_level_args(grids, masks, nu,
                                                        nu_fine))]

    def body(version, bs, xs, xc, w_levels, w0_levels, dt, pinvs):
        for l in range(len(steps) - 1, -1, -1):
            xc = getattr(steps[l], version)(bs[l], xs[l], xc, w_levels[l],
                                            w0_levels[l], dt, pinvs[l])
        return xc

    return _wrap("ascend_chain", body, lambda a: a[2][0])
