"""Dry run of the sharded fused smoother over a mesh of shards.

    python -m pfhubbenchmarks_tpu_torch.parallel.dryrun [--mesh 2x4]
        [--comm local|dist] [--bench bench1|bench3] [--nx N]
        [--device cuda|cpu]

The counterpart of the fourth phase of ``__graft_entry__.dryrun_multichip``
(:150-185): the benchmark at ``aligned_pad_to`` for the mesh; r = -residual(w,
w, dt) from the halo residual (parallel/halo.py, f64, then f32); P^-1 by
``solve/precond.make_block_jacobi``; 2 sweeps of the sharded smoother
(parallel/halo_smoother.py, kernel S) from x = 0; ||r|| must fall; then the
benchmark's observables from the halo functional. Defaults: bench1 at
100^2 on the card, every shard of a 2 x 4 mesh in this process
(``--comm local``). ``--comm dist`` runs one shard per process of
``torch.distributed``, started by ``torchrun --nproc-per-node N``, which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT (NCCL on
the card, rank r on GPU LOCAL_RANK; gloo with ``--device cpu``); the mesh
then defaults to the near-square one of the world size. The JAX dry run's
first three phases (SPMD Newton steps of bench1, bench6 and bench1_3d) are
not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch
import torch.distributed as dist

from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark
from pfhubbenchmarks_tpu_torch.parallel.comm import DistComm, LocalComm
from pfhubbenchmarks_tpu_torch.parallel.halo import (aligned_pad_to,
                                                     make_halo_functional,
                                                     make_halo_residual)
from pfhubbenchmarks_tpu_torch.parallel.halo_smoother import (
    make_sharded_lmr_sweep)
from pfhubbenchmarks_tpu_torch.parallel.mesh import (ShardMesh,
                                                     default_device_mesh_shape,
                                                     shard_state)
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

DT = 0.1
N_SWEEPS = 2
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def aligned_problem(bench: str, nx: int, mesh: ShardMesh):
    """The benchmark at nx x nx on a grid padded to ``aligned_pad_to``."""
    problem = get_benchmark(bench, nx=nx, ny=nx)
    grid = dataclasses.replace(problem.grid,
                               pad_to=aligned_pad_to(nx, nx, mesh.shape))
    return dataclasses.replace(problem, grid=grid)


def run(bench: str, nx: int, comm, *, verbose: bool = True) -> dict:
    """The dry run over ``comm``'s shards; returns the residual norms before
    and after the sweeps and the observables."""
    problem = aligned_problem(bench, nx, comm.mesh)
    if problem.kernel_phys is None:
        raise ValueError(f"{bench}: kernel S has no instantiation for it")
    g, F, dev = problem.grid, problem.n_fields, comm.device
    w = problem.initial_state(dev)
    ws = shard_state(w, comm)
    res = make_halo_residual(g, problem.terms, F, comm,
                             dirichlet=problem.dirichlet)
    r = [tuple((-a).float() for a in pair) for pair in res(ws, ws, DT)]
    w32 = tuple(a.float() for a in w)
    pinv = make_block_jacobi(g, problem.terms, F, device=dev,
                             dirichlet=problem.dirichlet)(w32, w32,
                                                          DT).pinv_planes
    sweep = make_sharded_lmr_sweep(g, problem.kernel_phys(), F, comm)
    x0 = [tuple(torch.zeros_like(a) for a in pair) for pair in r]
    w32s = shard_state(w32, comm)

    def norm(shards):
        parts = [sum(torch.sum(a.double() ** 2) for a in pair) for pair in shards]
        return float(torch.sqrt(comm.allreduce_sum(parts)))

    n0 = norm(r)
    _, r1 = sweep(x0, r, w32s, w32s, shard_state(pinv, comm), DT, N_SWEEPS)
    n1 = norm(r1)
    if not n1 < n0:
        raise AssertionError(f"dry run: ||r|| did not fall ({n0} -> {n1})")
    obs = {}
    for name, density in problem.observables.items():
        value = float(make_halo_functional(g, density, comm)(ws))
        obs[name] = value * problem.observable_scale.get(name, 1.0)
    out = dict(bench=bench, nx=nx, stored=list(g.vshape),
               mesh=list(comm.mesh.shape), comm=type(comm).__name__,
               device=str(dev), sweeps=N_SWEEPS, residual_norm=[n0, n1],
               observables=obs)
    if verbose:
        print(f"dryrun: {bench} {nx}x{nx} (stored {g.vshape[0]}x{g.vshape[1]}) "
              f"on mesh {comm.mesh.my}x{comm.mesh.mx}, {type(comm).__name__} "
              f"on {dev}: sharded fused smoother ||r|| {n0:.6e} -> {n1:.6e} "
              f"({N_SWEEPS} sweeps); "
              + ", ".join(f"{k} {v:.12g}" for k, v in obs.items()), flush=True)
    return out


def _parse_mesh(text: str) -> tuple[int, int]:
    my, mx = text.lower().split("x")
    return int(my), int(mx)


def _init_dist(device: str) -> torch.device:
    """The process group of a torchrun launch; the device of this rank."""
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise SystemExit(f"--comm dist runs under torchrun: {missing} not set")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="sharded fused smoother dry run")
    ap.add_argument("--mesh", type=_parse_mesh, default=None,
                    help="MYxMX (default 2x4, or near-square of the world "
                         "size with --comm dist)")
    ap.add_argument("--comm", choices=("local", "dist"), default="local")
    ap.add_argument("--bench", choices=("bench1", "bench3"), default="bench1")
    ap.add_argument("--nx", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    if args.comm == "local":
        comm = LocalComm(ShardMesh(*(args.mesh or (2, 4))), args.device)
        return run(args.bench, args.nx, comm)
    dev = _init_dist(args.device)
    try:
        shape = args.mesh or default_device_mesh_shape(dist.get_world_size())
        comm = DistComm(ShardMesh(*shape), dev)
        out = run(args.bench, args.nx, comm, verbose=comm.rank == 0)
        if comm.rank == 0:
            print(json.dumps(out), flush=True)
        return out
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
