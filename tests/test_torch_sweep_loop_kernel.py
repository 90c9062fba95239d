"""Kernel L's CPU side (ops/lmr.py: the sweep loop of a gather level in one
launch), with the JAX package as the oracle:

- the plain sweep loop (``sweep.plain``, which the kernel is held against on
  the card) against the TPU kernels it replaces, on seeded numpy inputs, 2
  sweeps at the dunavant2 level rule: bench1 (12^2) and bench3 (10^2)
  against ``make_pallas_lmr_sweep_loop`` (TPU row 3) in interpret mode;
  bench6 (12^2, Dirichlet rows of phi) against ``make_fused_descend`` with
  its BC masks (row 6, the sweeps from x = 0 of a level step), since the
  loop kernel has no Dirichlet rows. bench2 and 3D are covered by
  tests/test_torch_bench2_sweeps.py and test_torch_bench1_3d_sweeps.py.
- the launch description L takes from each benchmark's level J.v
  (``jv.launch``: the physics, its constants and tabulation, the rule, the
  mask; and the sweep's field groups) is what that J.v's own launcher
  receives, read from the calls of a recording stand-in for the library.
- L's slot partition: the nb the wrapper passes is ``lmr_partial_blocks``,
  as kernel C's wrapper passes it, and the stride of L's phase 3 is C's.
- on a CPU tensor the wrapper routes to the plain loop, and the kernel
  raises.

f32 tolerances are those of tests/test_pallas_vcycle.py (rtol 2e-4, atol
2e-5): the two sides sum in different orders.
"""

import ctypes
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu.benchmarks import bench1 as jbench1
from pfhubbenchmarks_tpu.benchmarks import bench3 as jbench3
from pfhubbenchmarks_tpu.benchmarks import bench6 as jbench6
from pfhubbenchmarks_tpu.ops.pallas_residual import make_pallas_lmr_sweep_loop
from pfhubbenchmarks_tpu.ops.pallas_vcycle import make_fused_descend
from pfhubbenchmarks_tpu_torch.benchmarks import (bench1, bench1_3d, bench2,
                                                  bench3, bench6)
from pfhubbenchmarks_tpu_torch.interop import state_from_numpy, state_to_numpy
from pfhubbenchmarks_tpu_torch.ops import _lib, lmr
from pfhubbenchmarks_tpu_torch.solve.precond import make_block_jacobi

F32 = dict(rtol=2e-4, atol=2e-5)
CSRC = Path(lmr.__file__).resolve().parent.parent / "csrc"
N_SWEEPS = 2


def _j(pair):
    return tuple(jnp.asarray(a) for a in pair)


def _t(pair):
    return state_from_numpy(pair, "cpu", torch.float32)


def _inputs(pt, g, seed, dt):
    """The IC on ``g`` plus seeded noise (with its Dirichlet values), the
    port's block planes there, and a random residual: f32 numpy."""
    F = pt.n_fields
    rng = np.random.default_rng(seed)
    v, m = g.interpolate(pt.ic_fns)
    w = _t(tuple(a + 0.02 * rng.standard_normal(a.shape) for a in (v, m)))
    for bc in pt.dirichlet_for(g):
        w = (bc.apply_value(w[0]).contiguous(), w[1])
    pinv = make_block_jacobi(g, pt.terms, F, device="cpu",
                             dirichlet=pt.dirichlet_for(g))(w, w, dt).pinv_planes
    r = tuple(rng.standard_normal((F,) + s).astype(np.float32)
              for s in (g.vshape, g.mshape))
    return state_to_numpy(w), tuple(p.numpy() for p in pinv), r


@pytest.mark.parametrize("name,n", [("bench1", 12), ("bench6", 12),
                                    ("bench3", 10)])
def test_plain_sweep_loop_matches_pallas(name, n):
    jmake, tmake = {"bench1": (jbench1.make, bench1.make),
                    "bench6": (jbench6.make, bench6.make),
                    "bench3": (jbench3.make, bench3.make)}[name]
    pj, pt = jmake(nx=n, ny=n), tmake(nx=n, ny=n)
    gj = dataclasses.replace(pj.grid, rule_name="dunavant2")
    gt = dataclasses.replace(pt.grid, rule_name="dunavant2")
    F, dt = pt.n_fields, 0.05
    w, pinv, r = _inputs(pt, gt, seed=n, dt=dt)
    x = tuple(np.zeros_like(a) for a in r)

    sweep = lmr.make_lmr_sweep_loop(
        pt.kernel_jvp(gt, "cpu", pt.dirichlet_for(gt)), N_SWEEPS)
    _lib.reset_launches()
    xt, rt = _t(x), _t(r)
    out = sweep(xt, rt, _t(w), _t(w), dt, *_t(pinv))
    assert out[0] is xt and out[1] is rt   # updated in place
    assert all(k == 0 for k in {**_lib.LAUNCHES, **_lib.CALLS}.values())

    if name == "bench6":
        # 2 masked sweeps from x = 0 are the x of a descend step
        coarse = dataclasses.replace(gj, nx=n // 2, ny=n // 2)
        jd = make_fused_descend(gj, coarse, pj.terms, F, nu=N_SWEEPS,
                                bcs_fine=pj.dirichlet_for(gj),
                                bcs_coarse=pj.dirichlet_for(coarse),
                                interpret=True)
        refs = ((xt, jd(_j(r), _j(w), _j(w), dt, _j(pinv))[0]),)
    else:
        jsweep = make_pallas_lmr_sweep_loop(gj, pj.terms, F, n_sweeps=N_SWEEPS)
        xj, rj = jsweep(_j(x), _j(r), _j(w), _j(w), dt, *_j(pinv),
                        interpret=True)
        refs = ((xt, xj), (rt, rj))
    for got, ref in refs:
        for a, b in zip(state_to_numpy(got), ref):
            np.testing.assert_allclose(a, np.asarray(b), **F32)


class _Recorder:
    """Stands in for the kernel library: records each launcher's name and
    arguments; for a J.v (gather or 3D tet box) or L launcher (whose first
    argument is the parameter block) the block, copied out while it is
    alive."""

    def __init__(self, param_floats):
        self.calls = []
        self.param_floats = param_floats
        self.lib = self

    def pfh_jvp_param_floats(self):
        return self.param_floats

    pfh_jvp3_param_floats = pfh_jvp_param_floats

    def call(self, name, *args):
        if name.endswith(("_jvp", "_tile")) or name.startswith("pfh_lmr_loop_"):
            block = np.ctypeslib.as_array((ctypes.c_float * self.param_floats)
                                          .from_address(args[0])).copy()
            self.calls.append((name, block, args[1:]))
        else:
            self.calls.append((name, None, args))


def _problem(name):
    if name == "bench1_3d":
        return bench1_3d.make(nx=4, ny=4, nz=4), None
    if name == "bench2":
        pt = bench2.make(nx=8, ny=8)
        return pt, pt.field_groups
    return {"bench1": bench1.make, "bench6": bench6.make,
            "bench3": bench3.make}[name](nx=8, ny=8), None


@pytest.mark.parametrize("name", ["bench1", "bench6", "bench2", "bench3",
                                  "bench1_3d"])
def test_launch_description_is_the_jvps(name, monkeypatch):
    pt, groups = _problem(name)
    F, dt = pt.n_fields, 0.25
    g = dataclasses.replace(pt.grid, rule_name=pt.solver.precond_rule)
    three_d = name == "bench1_3d"
    if three_d:
        jv = pt.kernel_jvp(g, "cpu")
        shapes = (g.vshape,)
    else:
        jv = pt.kernel_jvp(g, "cpu", pt.dirichlet_for(g),
                           split=groups is not None)
        shapes = (g.vshape, g.mshape)
    launch = jv.launch
    assert (launch.n_fields, launch.dims) == (
        F, (g.nz, g.ny, g.nx) if three_d else (g.ny, g.nx))
    assert (launch.mask is not None) == bool(
        not three_d and pt.dirichlet_for(g))

    rng = np.random.default_rng(3)
    w, v, x, r = (tuple(torch.tensor(rng.standard_normal((F,) + s),
                                     dtype=torch.float32) for s in shapes)
                  for _ in range(4))
    pinv = tuple(torch.zeros((F, F) + s) for s in shapes)
    rec = _Recorder(launch.head.size + 1)
    monkeypatch.setattr(_lib, "library", lambda: rec)
    monkeypatch.setattr(_lib, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_lib, "stream_handle", lambda: 0)
    jv.kernel(w, w, dt, v)
    lmr.lmr_sweep_kernel(launch, N_SWEEPS, x, r, w, dt, pinv, groups)
    lmr.lmr_step_kernel(x, r, v, v, groups)
    _lib.reset_launches()
    (jv_name, jv_block, jv_args), (l_name, l_block, l_args), \
        (c_name, _, c_args) = rec.calls

    # the physics, its constants, tabulation and dt, the rule, the variant
    # (a 3D level's J.v is kernel U, the tet boxes whose body L runs)
    assert jv_name == f"pfh_{launch.kind}_{'tile' if three_d else 'jvp'}"
    assert l_name == f"pfh_lmr_loop_{launch.kind}"
    np.testing.assert_array_equal(l_block, jv_block)
    n_var = len(launch.variant)
    assert l_args[:1 + n_var] == jv_args[:1 + n_var] == (launch.nq,
                                                          *launch.variant)
    # the Dirichlet mask: the same tensor
    if not three_d:
        assert l_args[1 + n_var + 12] == jv_args[1 + n_var + 6]
        assert l_args[1 + n_var + 12] == (None if launch.mask is None
                                          else launch.mask.data_ptr())
    # the slot partition and the groups: C's nb and starts
    n_ptrs = 6 if three_d else 13
    nb, n_groups, starts, n_sweeps = l_args[1 + n_var + n_ptrs + 1:
                                            1 + n_var + n_ptrs + 5]
    assert c_name == "pfh_lmr_step"
    c_groups, c_starts, c_nb = c_args[11], c_args[12], c_args[14]
    n_nodes = sum(int(np.prod(s)) for s in shapes)
    assert nb == c_nb == lmr.lmr_partial_blocks(F * n_nodes)
    assert n_groups == c_groups and n_sweeps == N_SWEEPS
    want = lmr.group_starts(groups)
    assert (None if starts is None else tuple(starts)) == want
    assert (None if c_starts is None else tuple(c_starts)) == want


def _cuda_constant(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         (CSRC / src).read_text()).group(1))


@pytest.mark.parametrize("n", [1, 255, 2602, 7806, 491_402])
def test_slot_partition_is_kernel_cs(n):
    """L's phase 3 (lmr_loop.cuh) sums entry i of a group's vector in slot
    b = (i // T) mod nb at thread t = i mod T, as C's stage 1 (lmr.cu) with
    blockIdx.x = b, blockDim.x = T and gridDim.x = nb does: both loops
    start at b T + t and stride nb T, with T the same 256."""
    T = _cuda_constant("lmr_loop.cuh", "kLoopThreads")
    assert T == _cuda_constant("lmr.cu", "kRedThreads") == lmr._LMR_THREADS
    assert _cuda_constant("lmr_loop.cuh", "kLoopMaxSlots") == lmr._LMR_MAX_BLOCKS
    nb = lmr.lmr_partial_blocks(n)
    loop_l = "i = static_cast<long>(b) * kLoopThreads + t; i < n;\n" \
             "         i += static_cast<long>(A.nb) * kLoopThreads"
    loop_c = ("i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x; "
              "i < n;\n       i += static_cast<long>(gridDim.x) * blockDim.x")
    assert loop_l in (CSRC / "lmr_loop.cuh").read_text()
    assert loop_c in (CSRC / "lmr.cu").read_text()
    seen = np.zeros(n, int)
    for b in range(nb):
        for t in range(T):
            idx = np.arange(b * T + t, n, nb * T)
            assert np.all((idx // T) % nb == b) and np.all(idx % T == t)
            seen[idx] += 1
    assert np.all(seen == 1)


def test_cpu_tensors_take_the_plain_loop_and_the_kernel_raises():
    pt = bench1.make(nx=6, ny=6)
    g = dataclasses.replace(pt.grid, rule_name="dunavant2")
    w, pinv, r = _inputs(pt, g, seed=1, dt=0.1)
    sweep = lmr.make_lmr_sweep_loop(pt.kernel_jvp(g, "cpu"), N_SWEEPS)
    args = (_t(w), _t(w), 0.1, *_t(pinv))
    x1, r1 = sweep(_t(tuple(np.zeros_like(a) for a in r)), _t(r), *args)
    x2, r2 = sweep.plain(_t(tuple(np.zeros_like(a) for a in r)), _t(r), *args)
    for a, b in zip(x1 + r1, x2 + r2):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.kernel(_t(tuple(np.zeros_like(a) for a in r)), _t(r), *args)
