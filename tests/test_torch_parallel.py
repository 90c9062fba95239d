"""The port's parallel layer (``pfhubbenchmarks_tpu_torch/parallel``) against
the JAX package's on the virtual 8-device CPU mesh (tests/conftest.py), on
seeded numpy inputs:

- the mesh order and default shape; the ``LocalComm`` operations;
- ``extend`` on a 2 x 4 ``LocalComm`` against ``halo_smoother._extend`` under
  ``shard_map``, per shard, bit for bit (an exchange moves data only);
- the halo residual (bench1, and bench6 with its Dirichlet rows, at 16^2)
  and the halo functional against ``make_halo_residual`` and
  ``make_halo_functional``, f64, rel 1e-12;
- kernel S's plain version against the global z = P^-1 r and ``jax.jvp`` of
  the f32 residual, and ``make_sharded_lmr_sweep`` against the JAX package's
  sharded sweep (Pallas in interpret mode) and against
  ``_reference_sweeps`` of tests/test_halo_smoother.py, n = 1 and 3, at that
  file's rtol 2e-4 / atol 2e-5 (f32 sums in other orders);
- the dry run with ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pfhubbenchmarks_tpu.benchmarks import get_benchmark as get_jax
from pfhubbenchmarks_tpu.config import (default_device_mesh_shape as
                                        jax_mesh_shape)
from pfhubbenchmarks_tpu.fem.assembly import make_residual as jax_residual
from pfhubbenchmarks_tpu.parallel.halo import aligned_pad_to as jax_aligned
from pfhubbenchmarks_tpu.parallel.halo import make_halo_functional as jax_hf
from pfhubbenchmarks_tpu.parallel.halo import make_halo_residual as jax_hr
from pfhubbenchmarks_tpu.parallel.halo_smoother import _extend as jax_extend
from pfhubbenchmarks_tpu.parallel.halo_smoother import (
    make_sharded_lmr_sweep as jax_sweep)
from pfhubbenchmarks_tpu.parallel.mesh import make_device_mesh
from pfhubbenchmarks_tpu.parallel.mesh import shard_state as jax_shard
from pfhubbenchmarks_tpu_torch.fem.assembly import make_functional, make_residual
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.shard_sweep import cell_mask, make_shard_sweep
from pfhubbenchmarks_tpu_torch.parallel import dryrun
from pfhubbenchmarks_tpu_torch.parallel.comm import LocalComm
from pfhubbenchmarks_tpu_torch.parallel.halo import (aligned_pad_to, block_grid,
                                                     extend, extend_pairs,
                                                     make_halo_functional,
                                                     make_halo_residual)
from pfhubbenchmarks_tpu_torch.parallel.halo_smoother import (
    make_sharded_lmr_sweep)
from pfhubbenchmarks_tpu_torch.parallel.mesh import (ShardMesh,
                                                     default_device_mesh_shape,
                                                     join_state, shard_state,
                                                     split_array)
from tests.test_halo_smoother import _reference_sweeps, _setup

F32 = dict(rtol=2e-4, atol=2e-5)
N = 16


@pytest.fixture(scope="module")
def jmesh():
    return make_device_mesh(8)


@pytest.fixture(scope="module")
def comm():
    return LocalComm(ShardMesh(2, 4), "cpu")


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_mesh_order_and_default_shape(jmesh):
    # rank r at (r // mx, r % mx): the device order of make_device_mesh
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    mesh = ShardMesh(*jmesh.devices.shape)
    for r in range(mesh.size):
        assert ids[mesh.coords(r)] == jax.devices()[r].id
    for n in range(1, 17):
        assert default_device_mesh_shape(n) == jax_mesh_shape(n)
    assert default_device_mesh_shape(8) == (2, 4)
    assert aligned_pad_to(100, 100, (2, 4)) == jax_aligned(100, 100, (2, 4))
    assert aligned_pad_to(350, 350, (2, 4)) == (352, 352)


def test_local_comm_operations():
    comm = LocalComm(ShardMesh(2, 2), "cpu")
    lines = [torch.full((3,), float(r + 1)) for r in range(4)]
    # ranks (0, 0) (0, 1) / (1, 0) (1, 1): along y, 0 <-> 2 and 1 <-> 3
    assert [float(t[0]) for t in comm.pull_prev(lines, "y")] == [0, 0, 1, 2]
    assert [float(t[0]) for t in comm.pull_next(lines, "y")] == [3, 4, 0, 0]
    assert [float(t[0]) for t in comm.pull_next(lines, "x")] == [2, 0, 4, 0]
    assert [float(t[0]) for t in comm.pull_prev(lines, "x")] == [0, 1, 0, 3]
    total = comm.allreduce_sum([torch.tensor(float(r)) for r in range(4)])
    assert float(total) == 6.0


@pytest.mark.parametrize("lead,hi", [((2,), 1), ((2,), 0), ((2, 2), 1)])
def test_extend_matches_jax_per_shard(jmesh, comm, lead, hi):
    rng = np.random.default_rng(1)
    a = rng.standard_normal(lead + (16, 24)).astype(np.float32)
    spec = P(*([None] * len(lead)), "y", "x")
    f = jax.shard_map(lambda b: jax_extend(b, 2, 4, hi=hi), mesh=jmesh,
                      in_specs=spec, out_specs=spec)
    ref = split_array(torch.tensor(np.asarray(f(jnp.asarray(a)))), comm.mesh)
    got = extend(split_array(torch.tensor(a), comm.mesh), comm, hi=hi)
    for g, r in zip(got, ref):
        assert g.shape == (*lead, 8 + 1 + hi, 6 + 1 + hi)
        assert torch.equal(g, r)


def _problems(name):
    pad = jax_aligned(N, N, (2, 4))
    pj = get_jax(name, nx=N, ny=N, pad_to=pad)
    pt = dryrun.aligned_problem(name, N, ShardMesh(2, 4))
    assert pt.grid.vshape == pj.grid.vshape == pj.grid.mshape
    return pj, pt


def _noisy_state(pj, seed):
    """The IC plus seeded noise on the logical nodes (the padding stays 0)."""
    g = pj.grid
    rng = np.random.default_rng(seed)
    v, m = (np.asarray(a).copy() for a in pj.initial_state())
    v[:, : g.ny + 1, : g.nx + 1] += 0.01 * rng.standard_normal(
        (v.shape[0], g.ny + 1, g.nx + 1))
    m[:, : g.ny, : g.nx] += 0.01 * rng.standard_normal((m.shape[0], g.ny, g.nx))
    return v, m


@pytest.mark.parametrize("name", ["bench1", "bench6"])
def test_halo_residual_and_functional_match_jax(jmesh, comm, name):
    pj, pt = _problems(name)
    w = _noisy_state(pj, seed=2)
    w0 = tuple(np.asarray(a) for a in pj.initial_state())
    assert len(pt.dirichlet) == (2 if name == "bench6" else 0)
    ref = jax.jit(jax_hr(pj.grid, pj.terms, pj.n_fields, jmesh,
                         dirichlet=pj.dirichlet))(
        jax_shard(tuple(map(jnp.asarray, w)), jmesh),
        jax_shard(tuple(map(jnp.asarray, w0)), jmesh), 0.1)
    res = make_halo_residual(pt.grid, pt.terms, pt.n_fields, comm,
                             dirichlet=pt.dirichlet)
    got = join_state(res(shard_state(state_from_numpy(w, "cpu"), comm),
                         shard_state(state_from_numpy(w0, "cpu"), comm), 0.1),
                     comm.mesh)
    for a, b in zip(state_to_numpy(got), ref):
        assert _rel(a, np.asarray(b)) <= 1e-12
    # and the port's own global residual
    glob = make_residual(pt.grid, pt.terms, pt.n_fields, device="cpu",
                         dirichlet=pt.dirichlet)(state_from_numpy(w, "cpu"),
                                                 state_from_numpy(w0, "cpu"), 0.1)
    for a, b in zip(got, glob):
        assert _rel(a.numpy(), b.numpy()) <= 1e-12
    for obs, density in pt.observables.items():
        want = float(jax_hf(pj.grid, pj.observables[obs], jmesh)(
            jax_shard(tuple(map(jnp.asarray, w)), jmesh)))
        value = float(make_halo_functional(pt.grid, density, comm)(
            shard_state(state_from_numpy(w, "cpu"), comm)))
        assert abs(value - want) <= 1e-12 * abs(want)
        glob = float(make_functional(pt.grid, density, device="cpu")(
            state_from_numpy(w, "cpu")))
        assert abs(value - glob) <= 1e-12 * abs(glob)


@pytest.fixture(scope="module")
def sweep_case(jmesh):
    """test_halo_smoother's bench1 case on the 2 x 4 mesh, as numpy."""
    pb, w, r, pinv, dt = _setup(jmesh)
    to_np = lambda t: tuple(np.asarray(a) for a in t)  # noqa: E731
    return pb, to_np(w), to_np(r), to_np(pinv), dt


def _shards(pair, comm):
    return shard_state(state_from_numpy(pair, "cpu", torch.float32), comm)


def test_shard_sweep_plain_matches_global_jvp(comm, sweep_case):
    """S's plain version on every shard: the owned windows of the global
    z = P^-1 r and of jax.jvp of the f32 residual in the direction z."""
    pb, w, r, pinv, dt = sweep_case
    pt = dryrun.aligned_problem("bench1", N, comm.mesh)
    g = pt.grid
    by, bx = comm.mesh.block_shape(*g.vshape)
    s = make_shard_sweep(block_grid(g, by + 1, bx + 1), pt.kernel_phys(), 2,
                         device="cpu")
    ws, rs, ps = (extend_pairs(_shards(t, comm), comm) for t in (w, r, pinv))
    mask = extend([b[0] for b in shard_state((torch.tensor(cell_mask(g)),),
                                             comm)], comm, hi=0)
    out = [s(*a, dt) for a in zip(rs, ws, ws, ps, mask)]
    z = join_state([o[0] for o in out], comm.mesh)
    az = join_state([o[1] for o in out], comm.mesh)
    zj = tuple(jnp.einsum("ijyx,jyx->iyx", p, rl) for p, rl in zip(pinv, r))
    res32 = jax_residual(pb.grid, pb.terms, 2, dtype=jnp.float32)
    wj = tuple(map(jnp.asarray, w))
    _, azj = jax.jvp(lambda u: res32(u, wj, dt), (wj,), (zj,))
    for a, b in zip(list(z) + list(az), list(zj) + list(azj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("n", [1, 3])
def test_sharded_sweep_matches_jax(jmesh, comm, sweep_case, n):
    pb, w, r, pinv, dt = sweep_case
    x0 = tuple(np.zeros_like(a) for a in r)
    js = lambda t: jax_shard(tuple(map(jnp.asarray, t)), jmesh)  # noqa: E731
    sweep_j = jax_sweep(pb.grid, pb.terms, 2, jmesh, dtype=jnp.float32,
                        interpret=True)
    x_j, r_j = sweep_j(js(x0), js(r), js(w), js(w), tuple(map(jnp.asarray, pinv)),
                       dt, n)
    x_ref, r_ref = _reference_sweeps(pb, tuple(map(jnp.asarray, w)),
                                     tuple(map(jnp.asarray, r)),
                                     tuple(map(jnp.asarray, pinv)), dt, n)

    pt = dryrun.aligned_problem("bench1", N, comm.mesh)
    sweep = make_sharded_lmr_sweep(pt.grid, pt.kernel_phys(), 2, comm)
    _lib.reset_launches()
    r_in = _shards(r, comm)
    xs, rs = sweep(_shards(x0, comm), r_in, _shards(w, comm),
                   _shards(w, comm), _shards(pinv, comm), dt, n)
    assert _lib.LAUNCHES["shard_sweep"] == 0  # CPU tensors: the plain version
    got = [a.numpy() for a in join_state(xs, comm.mesh) + join_state(rs, comm.mesh)]
    for ref in (list(x_j) + list(r_j), list(x_ref) + list(r_ref)):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, np.asarray(b), **F32)
    # the sweep works on copies
    for a, b in zip(r_in, _shards(r, comm)):
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_dry_run_on_cpu(capsys):
    out = dryrun.main(["--device", "cpu", "--nx", str(N)])
    assert out["mesh"] == [2, 4] and out["stored"] == [18, 20]
    n0, n1 = out["residual_norm"]
    assert n1 < n0
    pt = dryrun.aligned_problem("bench1", N, ShardMesh(2, 4))
    w = pt.initial_state("cpu")
    r = make_residual(pt.grid, pt.terms, 2, device="cpu")(w, w, dryrun.DT)
    want = float(torch.sqrt(sum(torch.sum(a.float().double() ** 2) for a in r)))
    assert abs(n0 - want) <= 1e-6 * want
    for name, fn in pt.observable_fns("cpu").items():
        assert abs(out["observables"][name] - float(fn(w))) <= 1e-12 * abs(
            float(fn(w)))
    assert "sharded fused smoother" in capsys.readouterr().out
