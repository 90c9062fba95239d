"""Grid-transfer operators for the nested crossed-triangle hierarchy.

Counterpart of ``pfhubbenchmarks_tpu/solve/transfer.py`` for dyadic pairs
and equal odd ratios (3, 5, 7; bench3's 350 -> 175 -> 35 -> 7): the coarse
crossed mesh is exactly refined by the fine one, so injection restricts
states for coarse rediscretization (coarse nodes are fine nodes),
prolongation is exact P1 interpolation and restriction its transpose. The
factories return ``apply(w)``; the work is done by kernel D (dyadic) or H
(equal odd ratio) in ops/transfer.py, or their plain versions for CPU
tensors. General injection is strided slicing on any device, as the JAX
package computes it outside its kernels.

Unequal per-axis ratios (semicoarsening) and periodic pairs are not yet
ported: the factories raise for those pairs (``ops/transfer.equal_ratio``
checks a pair).
"""

from __future__ import annotations

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import transfer as kt


def _general(coarse: CrossedTriGrid, fine: CrossedTriGrid) -> None:
    if kt.equal_ratio(coarse, fine) == 2:
        raise ValueError("a dyadic pair: use prolong_any / restrict_any / "
                         "inject_any")


def prolong_general(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """Exact P1 interpolation for an equal odd ratio."""
    _general(coarse, fine)
    return lambda wc: kt.prolong(wc, coarse, fine)


def restrict_general(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """The exact transpose of ``prolong_general`` (Galerkin residual
    transfer)."""
    _general(coarse, fine)
    return lambda rf: kt.restrict(rf, coarse, fine)


def inject_state_general(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """Coarse vertices are fine vertices; with R odd a coarse centre is the
    fine centre at offset (R-1)/2 of its cell."""
    _general(coarse, fine)
    return lambda wf: kt.inject_general(wf, coarse, fine)


def inject_state(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """State restriction by injection (coarse nodes are fine nodes)."""
    return lambda wf: kt.inject(wf, coarse, fine)


def prolong_any(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    kt.equal_ratio(coarse, fine)
    return lambda wc: kt.prolong(wc, coarse, fine)


def restrict_any(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    kt.equal_ratio(coarse, fine)
    return lambda rf: kt.restrict(rf, coarse, fine)


def inject_any(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    kt.equal_ratio(coarse, fine)
    return inject_state(coarse, fine)
