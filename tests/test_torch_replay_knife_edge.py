"""bench2's replay step to t = 81.51 (ROADMAP Queue 3 item 3): where the
port's Newton and the JAX package's part on the system that decides its
rung.

``tests/data/bench2_replay_row109.npz`` holds the port's state at row 109
of ``results/bench2_replay.csv`` (t = 80.87, saved on the card by
``tools/torch_replay_state.py``) and the port's root of the continuation
system at 0.7 dt from it (the rescue ladder's last fraction that converges,
added on the CPU by the same tool with ``--save-root``). The reference run
solved the step by the continuation in dt; the port reaches the ladder's
last rung, because its continuation fails at 0.85 dt.

From that root, both packages' Newton on the 0.85 dt system, with the same
Krylov settings (the replay's fixed forcing), go the same way: the first
Newton step raises ||F|| ninefold in both (0.2885 to 2.680), and the norms
of the first three iterates agree to rel 2e-4. Run to its end (the tool's
trace), each solve fails after five iterations, the last two norms within
rel 2e-3 of each other's. They part only in the f32 Krylov solves (87
iterations over the five in the port, 113 in the JAX package, both on the
CPU: the rounding of the f32 dots, tests/test_torch_krylov_parity.py). So
the step is a knife edge of the f32 Krylov rounding; the f64 residual, the
f32 J.v and the line search are not where the two part. The test runs the
first three iterations of each solve.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import torch

from pfhubbenchmarks_tpu import timeloop as jax_timeloop
from pfhubbenchmarks_tpu.benchmarks.bench2 import make as make_jax2
from pfhubbenchmarks_tpu_torch import timeloop
from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import make as make_torch2

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "bench2_replay_row109.npz")
FRAC = 0.85
ITERS = 3


def _fixed(problem):
    """The replay's fixed forcing, and the first ITERS Newton iterations."""
    return dataclasses.replace(problem, solver=dataclasses.replace(
        problem.solver, krylov_forcing="fixed", newton_max_iters=ITERS))


def _finite(hist):
    return [float(h) for h in np.asarray(hist) if np.isfinite(h)]


def test_bench2_t8151_continuation_parts_only_in_the_krylov_solves():
    d = np.load(DATA)
    assert float(d["t"]) == 80.87 and float(d["root_frac"]) == 0.7
    dt = FRAC * float(d["dt"])
    w0 = (d["v"], d["m"])
    root = (d["v_root"], d["m_root"])

    runner = timeloop.Runner(_fixed(make_torch2()), "cpu")
    got, _ = runner.step(tuple(torch.tensor(a) for a in root),
                         tuple(torch.tensor(a) for a in w0), dt)
    jrunner = jax_timeloop.Runner(_fixed(make_jax2()))
    ref, _ = jrunner.step(tuple(jnp.asarray(a) for a in root),
                          tuple(jnp.asarray(a) for a in w0), dt)

    h_t, h_j = _finite(got.norm_hist), _finite(ref.norm_hist)
    assert len(h_t) == len(h_j) == ITERS + 1
    assert not got.converged and not bool(ref.converged)
    # the first Newton step raises ||F|| ninefold in both
    assert h_t[1] > 9 * h_t[0] and h_j[1] > 9 * h_j[0]
    # and the Newton residual norms agree: the f64 residual, the f32 J.v
    # and the line search do not part them
    np.testing.assert_allclose(h_t, h_j, rtol=1e-3)
    # the Krylov solves take their own counts (the f32 dots' rounding)
    assert got.krylov_iters > 0 and int(ref.krylov_iters) > 0
