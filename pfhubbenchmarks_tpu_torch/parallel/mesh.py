"""A 2D mesh of shards and the block layout of the fields over it.

Counterpart of ``pfhubbenchmarks_tpu/parallel/mesh.py``. The JAX package
shards the (y, x) axes of every field ``[F, Y, X]`` over a
``jax.sharding.Mesh`` with axes ``('y', 'x')`` (``P(None, 'y', 'x')``). Here
a ``ShardMesh(my, mx)`` names the same layout: rank r is mesh position
``(r // mx, r % mx)``, the order in which ``np.reshape(my, mx)`` lays the
devices out (``mesh.py:33``), and holds the block ``[..., by, bx]`` at rows
``[iy by, (iy + 1) by)`` and columns ``[ix bx, (ix + 1) bx)``.

``split_state`` / ``join_state`` move between a global state and the list of
its blocks in rank order; ``shard_state`` gives the blocks a communicator
(parallel/comm.py) holds: all of them for ``LocalComm``, the rank's own for
``DistComm``.
"""

from __future__ import annotations

import dataclasses

import torch

AXES = ("y", "x")


def default_device_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor n devices into a near-square (my, mx) 2D mesh (a copy of
    ``pfhubbenchmarks_tpu/config.py:default_device_mesh_shape``)."""
    my = int(n_devices**0.5)
    while n_devices % my:
        my -= 1
    return my, n_devices // my


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """``my`` x ``mx`` shards with axes ('y', 'x'); rank r sits at
    ``(r // mx, r % mx)``."""

    my: int
    mx: int

    def __post_init__(self):
        if self.my < 1 or self.mx < 1:
            raise ValueError(f"mesh shape ({self.my}, {self.mx})")

    @property
    def shape(self) -> tuple[int, int]:
        return self.my, self.mx

    @property
    def size(self) -> int:
        return self.my * self.mx

    def coords(self, rank: int) -> tuple[int, int]:
        return rank // self.mx, rank % self.mx

    def rank(self, iy: int, ix: int) -> int:
        return iy * self.mx + ix

    def neighbour(self, rank: int, axis: str, step: int) -> int | None:
        """The rank ``step`` positions along ``axis``, or None off the mesh."""
        c = list(self.coords(rank))
        a = AXES.index(axis)
        c[a] += step
        if not 0 <= c[a] < self.shape[a]:
            return None
        return self.rank(*c)

    def block_shape(self, Y: int, X: int) -> tuple[int, int]:
        if Y % self.my or X % self.mx:
            raise ValueError(f"grid ({Y}, {X}) does not divide over mesh "
                             f"{self.shape}")
        return Y // self.my, X // self.mx


def split_array(a: torch.Tensor, mesh: ShardMesh) -> list[torch.Tensor]:
    """``[..., Y, X]`` -> the blocks ``[..., by, bx]`` in rank order
    (contiguous copies)."""
    by, bx = mesh.block_shape(*a.shape[-2:])
    out = []
    for r in range(mesh.size):
        iy, ix = mesh.coords(r)
        out.append(a[..., iy * by:(iy + 1) * by,
                     ix * bx:(ix + 1) * bx].contiguous())
    return out


def join_array(blocks, mesh: ShardMesh) -> torch.Tensor:
    """The inverse of ``split_array``."""
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size}")
    rows = [torch.cat(list(blocks[iy * mesh.mx:(iy + 1) * mesh.mx]), dim=-1)
            for iy in range(mesh.my)]
    return torch.cat(rows, dim=-2)


def split_state(w, mesh: ShardMesh) -> list[tuple]:
    """A state tuple of global arrays (``(v, m)`` fields ``[F, Y, X]`` or
    planes ``[F, F, Y, X]``) -> one tuple of blocks per rank."""
    parts = [split_array(a, mesh) for a in w]
    return [tuple(p[r] for p in parts) for r in range(mesh.size)]


def join_state(blocks, mesh: ShardMesh) -> tuple:
    """The inverse of ``split_state``."""
    return tuple(join_array([b[i] for b in blocks], mesh)
                 for i in range(len(blocks[0])))


def shard_state(w, comm) -> list[tuple]:
    """The blocks of the global state ``w`` that ``comm`` holds, in the
    order of ``comm.ranks``."""
    blocks = split_state(w, comm.mesh)
    return [blocks[r] for r in comm.ranks]
