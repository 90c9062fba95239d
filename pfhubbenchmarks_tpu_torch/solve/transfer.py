"""Grid-transfer operators for the nested crossed-triangle hierarchy.

Counterpart of ``pfhubbenchmarks_tpu/solve/transfer.py`` for dyadic pairs:
a 2h crossed mesh is exactly refined by the h crossed mesh, so injection
restricts states for coarse rediscretization (coarse nodes are fine nodes).
The V-cycle's prolongation and restriction run inside the chains
(ops/vcycle_chain.py); the work is done by kernel D (ops/transfer.py), or
its plain version for CPU tensors.

The general odd-ratio and periodic transfers are not yet ported:
``inject_any`` raises for those pairs.
"""

from __future__ import annotations

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.ops import transfer as kt


def ratios(coarse: CrossedTriGrid, fine: CrossedTriGrid) -> tuple[int, int]:
    rx, ry = fine.nx // coarse.nx, fine.ny // coarse.ny
    if fine.nx != rx * coarse.nx or fine.ny != ry * coarse.ny:
        raise ValueError(f"not nested: {fine.ny}x{fine.nx} / "
                         f"{coarse.ny}x{coarse.nx}")
    return rx, ry


def inject_state(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    """State restriction by injection (coarse nodes are fine nodes)."""
    return lambda wf: kt.inject(wf, coarse, fine)


def _dyadic_only(coarse: CrossedTriGrid, fine: CrossedTriGrid) -> None:
    if fine.periodic or ratios(coarse, fine) != (2, 2):
        raise NotImplementedError(
            "only dyadic, non-periodic transfers are ported to the PyTorch "
            f"package ({fine.ny}x{fine.nx} -> {coarse.ny}x{coarse.nx})")


def inject_any(coarse: CrossedTriGrid, fine: CrossedTriGrid):
    _dyadic_only(coarse, fine)
    return inject_state(coarse, fine)
