"""``DistComm`` (parallel/comm.py) over ``torch.distributed``: 4 gloo ranks on
a 2 x 2 mesh, spawned from the test (a ``file://`` rendezvous in the test's
own directory, so parallel test workers do not collide), each holding one
shard. On every rank the exchanges, the all-reduce, the halo residual and
functional, and 3 sweeps of the sharded smoother (bench1 at 16^2, kernel S's
plain version) must equal what ``LocalComm`` gives for that shard, within
1e-6 (the sums differ in order only). A ``DistComm`` that cannot start
raises: no process group, a world size other than the mesh's, a backend
that does not serve the device. The dry run's ``--comm dist`` entry point,
started as torchrun starts it (4 gloo ranks, the launcher's environment),
gives the norms and observables of ``--comm local`` within 1e-6."""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pfhubbenchmarks_tpu_torch.parallel import dryrun
from pfhubbenchmarks_tpu_torch.parallel.comm import DistComm, LocalComm
from pfhubbenchmarks_tpu_torch.parallel.halo import (extend,
                                                     make_halo_functional,
                                                     make_halo_residual)
from pfhubbenchmarks_tpu_torch.parallel.halo_smoother import (
    make_sharded_lmr_sweep)
from pfhubbenchmarks_tpu_torch.parallel.mesh import ShardMesh, shard_state
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

MESH = ShardMesh(2, 2)
N = 16
TIMEOUT_S = 60


def _run(comm) -> dict:
    """Every operation of the layer on ``comm``'s shards; one list of
    tensors (one per held shard) per name."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.standard_normal((2, 18, 18)), dtype=torch.float32)
    blocks = shard_state((a,), comm)
    out = {"extend": extend([b[0] for b in blocks], comm),
           "extend_hi0": extend([b[0] for b in blocks], comm, hi=0),
           "allreduce": [comm.allreduce_sum([b[0].sum() for b in blocks])]}
    pt = dryrun.aligned_problem("bench1", N, comm.mesh)
    g = pt.grid
    w = pt.initial_state("cpu")
    ws = shard_state(w, comm)
    res = make_halo_residual(g, pt.terms, 2, comm)(ws, ws, 0.1)
    out["residual"] = [t for pair in res for t in pair]
    out["tfe"] = [make_halo_functional(g, pt.observables["total_free_energy"],
                                       comm)(ws)]
    w32 = tuple(t.float() for t in w)
    pinv = make_block_jacobi(g, pt.terms, 2, device="cpu")(w32, w32,
                                                           0.1).pinv_planes
    r = [tuple((-t).float() for t in pair) for pair in res]
    x0 = [tuple(torch.zeros_like(t) for t in pair) for pair in r]
    w32s = shard_state(w32, comm)
    sweep = make_sharded_lmr_sweep(g, pt.kernel_phys(), 2, comm)
    x, r = sweep(x0, r, w32s, w32s, shard_state(pinv, comm), 0.1, 3)
    out["sweep"] = [t for xi, ri in zip(x, r) for t in (*xi, *ri)]
    return out


def _raises(fn) -> bool:
    try:
        fn()
    except RuntimeError:
        return True
    return False


def _worker(rank, rendezvous, out_dir):
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=MESH.size)
    try:
        results = _run(DistComm(MESH, "cpu"))
        results["refused"] = [
            _raises(lambda: DistComm(ShardMesh(1, 2), "cpu")),
            _raises(lambda: DistComm(MESH, "cuda"))]
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_dist_comm_refuses_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        DistComm(MESH, "cpu")


def _dryrun_worker(rank, port, out_dir):
    """A rank of ``torchrun --nproc-per-node 4 -m ...parallel.dryrun --comm
    dist --device cpu``: the launcher's environment, then the entry point."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(MESH.size),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    out = dryrun.main(["--comm", "dist", "--device", "cpu", "--nx", str(N)])
    torch.save(out, f"{out_dir}/dryrun{rank}.pt")


def _spawn(fn, args):
    """Run ``fn(rank, *args)`` on MESH.size spawned processes; fail the test
    if they do not finish in TIMEOUT_S."""
    t0 = time.monotonic()
    ctx = mp.start_processes(fn, args=args, nprocs=MESH.size, join=False,
                             start_method="spawn")
    while not ctx.join(timeout=1):
        if time.monotonic() - t0 > TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {TIMEOUT_S} s")


def test_dist_comm_gloo_matches_local_comm(tmp_path):
    _spawn(_worker, (tmp_path / "rendezvous", tmp_path))
    local = _run(LocalComm(MESH, "cpu"))
    for rank in range(MESH.size):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        assert got.pop("refused") == [True, True]
        assert set(got) == set(local)
        for name, tensors in got.items():
            # LocalComm's per-shard lists hold every rank; the scalars are
            # the mesh-wide values every rank holds alike
            per_rank = len(local[name]) // MESH.size
            want = (local[name] if len(local[name]) == 1 else
                    local[name][rank * per_rank:(rank + 1) * per_rank])
            assert len(tensors) == len(want), name
            for a, b in zip(tensors, want):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                           msg=lambda m: f"{name}: {m}")


def test_dry_run_under_dist_matches_local(tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _spawn(_dryrun_worker, (port, tmp_path))
    local = dryrun.main(["--mesh", "2x2", "--device", "cpu", "--nx", str(N)])
    for rank in range(MESH.size):
        got = torch.load(tmp_path / f"dryrun{rank}.pt")
        assert got["comm"] == "DistComm" and got["mesh"] == [2, 2]
        np.testing.assert_allclose(got["residual_norm"], local["residual_norm"],
                                   rtol=1e-6, atol=0)
        for name, value in local["observables"].items():
            np.testing.assert_allclose(got["observables"][name], value,
                                       rtol=1e-6, atol=0)
