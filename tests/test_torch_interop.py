"""Interop between the two packages: config field parity, the state round
trip, the params carry-over, the no-jax import rule, and the knobs the
slice refuses."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pfhubbenchmarks_tpu import config as jax_config
from pfhubbenchmarks_tpu.benchmarks.bench1 import Bench1Params as JaxParams
from pfhubbenchmarks_tpu.benchmarks.bench1 import make as make_jax
from pfhubbenchmarks_tpu.benchmarks.bench6 import Bench6Params as JaxParams6
from pfhubbenchmarks_tpu.benchmarks.bench6 import make as make_jax6
from pfhubbenchmarks_tpu_torch import config
from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import Bench1Params
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import Bench6Params
from pfhubbenchmarks_tpu_torch.benchmarks.registry import main
from pfhubbenchmarks_tpu_torch.interop import (problem_params_from_numpy,
                                               solver_config_from_dict,
                                               state_from_numpy,
                                               state_to_numpy,
                                               time_config_from_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["SolverConfig", "TimeConfig"])
def test_config_fields_and_defaults_match_jax(name):
    a = dataclasses.fields(getattr(jax_config, name))
    b = dataclasses.fields(getattr(config, name))
    assert [(f.name, f.default) for f in a] == [(f.name, f.default) for f in b]


def test_bench1_configs_carry_over():
    pj = make_jax(nx=16, ny=16)
    s = solver_config_from_dict(dataclasses.asdict(pj.solver))
    t = time_config_from_dict(dataclasses.asdict(pj.time))
    assert dataclasses.asdict(s) == dataclasses.asdict(pj.solver)
    assert dataclasses.asdict(t) == dataclasses.asdict(pj.time)
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import make
    assert make(nx=16, ny=16).solver == s
    p = problem_params_from_numpy(
        {k: np.float64(v) for k, v in dataclasses.asdict(JaxParams()).items()})
    assert p == Bench1Params()


def test_bench6_configs_and_params_carry_over():
    pj = make_jax6(nx=16, ny=16)
    s = solver_config_from_dict(dataclasses.asdict(pj.solver))
    t = time_config_from_dict(dataclasses.asdict(pj.time))
    from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import make
    pt = make(nx=16, ny=16)
    assert pt.solver == s and pt.time == t
    config.check_supported(s)   # cp, the lagged build and split_chain
    assert [(f, side) for f, side, _ in pt.dirichlet_spec] == [
        (f, side) for f, side, _ in pj.dirichlet_spec]
    p = problem_params_from_numpy(
        {k: np.float64(v) for k, v in dataclasses.asdict(JaxParams6()).items()},
        Bench6Params)
    assert p == Bench6Params()
    with pytest.raises(ValueError):
        problem_params_from_numpy({}, dict)


@pytest.mark.parametrize("name", ["bench2", "bench2_eta1", "bench2_eta2"])
def test_bench2_configs_and_params_carry_over(name):
    from pfhubbenchmarks_tpu.benchmarks import get_benchmark as jax_benchmark
    from pfhubbenchmarks_tpu.benchmarks.bench2 import Bench2Params as JaxParams2
    from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import Bench2Params
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark

    pj = jax_benchmark(name, nx=16, ny=16)
    pt = get_benchmark(name, nx=16, ny=16)
    s = solver_config_from_dict(dataclasses.asdict(pj.solver))
    assert pt.solver == s and s.field_split
    assert pt.time == time_config_from_dict(dataclasses.asdict(pj.time))
    config.check_supported(s)   # field split, cp, dunavant1
    assert (pt.name, pt.field_names, pt.field_groups) == (
        pj.name, pj.field_names, pj.field_groups)
    p = problem_params_from_numpy(
        {k: np.float64(v) for k, v in dataclasses.asdict(JaxParams2()).items()},
        Bench2Params)
    assert p == Bench2Params()


def test_state_round_trip():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((2, 17, 17)), rng.standard_normal((2, 16, 16)))
    t = state_from_numpy(w, "cpu")
    assert all(a.dtype == torch.float64 and a.device.type == "cpu" for a in t)
    for a, b in zip(state_to_numpy(t), w):
        np.testing.assert_array_equal(a, b)
    t32 = state_from_numpy(w, "cpu", torch.float32)
    assert t32[0].dtype == torch.float32


def test_bench1_3d_state_configs_and_params_carry_over():
    from pfhubbenchmarks_tpu.benchmarks.bench1_3d import make as make_jax3d
    from pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d import make as make_torch3d

    pj, pt = make_jax3d(nx=4, ny=4, nz=4), make_torch3d(nx=4, ny=4, nz=4)
    assert solver_config_from_dict(dataclasses.asdict(pj.solver)) == pt.solver
    assert time_config_from_dict(dataclasses.asdict(pj.time)) == pt.time
    config.check_supported(pt.solver)   # fast_residual, kcycle 3, keast2
    assert problem_params_from_numpy(
        {k: np.float64(v) for k, v in dataclasses.asdict(JaxParams()).items()},
        Bench1Params) == Bench1Params()
    (v,) = (np.asarray(a) for a in pj.initial_state())
    (t,) = state_from_numpy((v,), "cpu")
    assert t.shape == (2, 5, 5, 5)
    np.testing.assert_array_equal(state_to_numpy((t,))[0], v)
    np.testing.assert_array_equal(t.numpy(), pt.initial_state("cpu")[0].numpy())


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pfhubbenchmarks_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('pfhubbenchmarks_tpu.') or k == 'pfhubbenchmarks_tpu')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=REPO)


@pytest.mark.parametrize("knob", [
    dict(line_search="bt"), dict(krylov="gmres"), dict(dense_impl="mxu"),
    dict(krylov_operator="precond_rule"), dict(gmg_cycle="w"), dict(gmg_inner_mr=2),
    dict(mixed_precision=False), dict(fgmres_aug=2),
    dict(field_split_alphas=False),
])
def test_unported_knobs_raise(knob):
    with pytest.raises(NotImplementedError):
        config.check_supported(config.SolverConfig(**knob))


def test_fast_residual_and_kcycle_are_accepted():
    config.check_supported(config.SolverConfig(fast_residual=True,
                                               gmg_kcycle=3,
                                               precond_rule="keast2"))


def test_tpu_only_knobs_are_accepted():
    config.check_supported(config.SolverConfig(
        use_pallas="on", fuse_vcycle="off", tiled_grid_kernels=True))


def test_tf32_is_off():
    assert config.tf32_disabled()


def test_cli_cuda_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main("bench1", ["--device", "cuda", "--max-steps", "1"])


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    """--device omitted means cuda: without a card the CLI exits non-zero
    with the error, and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device") as exc:
        main("bench1", ["--max-steps", "1"])
    assert exc.value.code not in (0, None)


def test_cli_refuses_unported_flags():
    with pytest.raises(SystemExit, match="not yet ported"):
        main("bench1", ["--device", "cpu", "--replay", "x.csv",
                        "--no-damped-rescue"])
