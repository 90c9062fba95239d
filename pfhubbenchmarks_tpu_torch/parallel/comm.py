"""The halo-exchange layer: the port's ``lax.ppermute`` and ``lax.psum`` over
a ``ShardMesh`` (parallel/mesh.py).

One interface, two implementations. A communicator holds the blocks of the
ranks in ``comm.ranks``; every operation takes one tensor per held rank, in
that order, and returns one per held rank:

- ``pull_prev(lines, axis)``: each shard receives its -1 neighbour's line
  along ``axis`` ('y' or 'x'), zeros at position 0
  (``halo_smoother.py:52-56``);
- ``pull_next(lines, axis)``: each shard receives its +1 neighbour's line,
  zeros at the last position (``halo_smoother.py:59-63``, ``halo.py:63-73``);
  ``pull_prev`` also carries a seam to the +1 neighbour, which adds it to
  its own first line (``halo.py:76-81``);
- ``allreduce_sum(parts)``: the sum over every rank of the mesh, one tensor
  (``lax.psum``).

``LocalComm(mesh, device)`` holds every shard in one process on one device,
as a list of blocks: an exchange is a device copy and the sum adds the
shards' parts in rank order. It is what one card runs, as the JAX package's
tests run on virtual CPU devices. ``DistComm(mesh, device)`` holds one shard
per rank of ``torch.distributed`` (rank r at mesh position r): lines go by
``batch_isend_irecv`` and parts by ``all_reduce``, over NCCL for CUDA
tensors and gloo for CPU tensors. Both give the same results up to the
order of the f32 sum. ``DistComm`` raises if it cannot start (no process
group, a world size other than the mesh's, a backend that does not serve
the device); it never becomes a ``LocalComm``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pfhubbenchmarks_tpu_torch.parallel.mesh import ShardMesh


class Comm:
    """The interface: ``mesh``, ``device``, ``ranks`` (the mesh positions
    this process holds) and the three operations. An implementation
    provides ``_send`` and ``allreduce_sum``."""

    mesh: ShardMesh
    device: torch.device
    ranks: tuple[int, ...]

    def _send(self, lines, axis: str, step: int) -> list[torch.Tensor]:
        """Every shard sends its line to the neighbour ``step`` positions
        along ``axis``; a shard with no sender receives zeros."""
        raise NotImplementedError

    def allreduce_sum(self, parts) -> torch.Tensor:
        raise NotImplementedError

    def pull_prev(self, lines, axis: str) -> list[torch.Tensor]:
        return self._send(lines, axis, +1)

    def pull_next(self, lines, axis: str) -> list[torch.Tensor]:
        return self._send(lines, axis, -1)

    def _check(self, items) -> None:
        if len(items) != len(self.ranks):
            raise ValueError(f"{len(items)} tensors for {len(self.ranks)} "
                             "held shards")


class LocalComm(Comm):
    """Every shard of ``mesh`` in this process, on ``device``."""

    def __init__(self, mesh: ShardMesh, device: torch.device | str):
        self.mesh = mesh
        self.device = torch.device(device)
        self.ranks = tuple(range(mesh.size))

    def _send(self, lines, axis, step):
        self._check(lines)
        out = []
        for r in self.ranks:
            src = self.mesh.neighbour(r, axis, -step)
            out.append(torch.zeros_like(lines[r]) if src is None
                       else lines[src].clone())
        return out

    def allreduce_sum(self, parts):
        self._check(parts)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


class DistComm(Comm):
    """One shard per rank of the initialized default process group."""

    def __init__(self, mesh: ShardMesh, device: torch.device | str):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("DistComm needs an initialized torch.distributed "
                               "process group")
        world = dist.get_world_size()
        if world != mesh.size:
            raise RuntimeError(f"DistComm: world size {world} for a mesh of "
                               f"{mesh.shape} ({mesh.size} shards)")
        self.device = torch.device(device)
        backend = dist.get_backend()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(f"DistComm: {self.device.type} tensors need the "
                               f"{want} backend, the process group has "
                               f"{backend}")
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.ranks = (self.rank,)
        # a first collective with every rank, on the device: NCCL asks that
        # of the group before its first batch of point-to-point operations
        dist.all_reduce(torch.zeros(1, device=self.device))

    def _send(self, lines, axis, step):
        self._check(lines)
        send = lines[0].contiguous()
        dst = self.mesh.neighbour(self.rank, axis, step)
        src = self.mesh.neighbour(self.rank, axis, -step)
        recv = torch.zeros_like(send) if src is None else torch.empty_like(send)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, dst))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, recv, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [recv]

    def allreduce_sum(self, parts):
        self._check(parts)
        total = parts[0].clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        return total
