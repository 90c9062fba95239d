"""Kernel P's plain version (``ops/fma_chain.py``) against the TPU probe's
Pallas kernel (``tools/probes/lanefill_probe.py``, TPU row 20) in interpret
mode. The kernel body and the probe's shapes are read from the probe's
source with ``ast`` (the probe runs its timing loop at module level, so it is
not imported): ``kernel`` is compiled with ``depth`` bound to 20 and run on
seeded [16,128] and [8,128] inputs; rtol 1e-6 (both run the same f32 steps
in the same order, the CPU's rounding differing by at most an ulp per op).
Also the wrapper's route for CPU tensors and the probe's shapes."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid
from pfhubbenchmarks_tpu_torch.ops import _lib
from pfhubbenchmarks_tpu_torch.ops.fma_chain import (SHAPES, fma_chain,
                                                     fma_chain_plain, inputs)

PROBE = Path(__file__).resolve().parent.parent / "tools/probes/lanefill_probe.py"
DEPTH = 20


def probe_source():
    return ast.parse(PROBE.read_text())


def tpu_kernel(depth: int):
    """The probe's ``kernel``, compiled alone with ``depth`` bound."""
    fn = next(node for node in probe_source().body
              if isinstance(node, ast.FunctionDef) and node.name == "kernel")
    namespace = {"depth": depth}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(PROBE), "exec"),
         namespace)
    return namespace["kernel"]


@pytest.mark.parametrize("shape", [(16, 128), (8, 128)])
def test_plain_matches_tpu_kernel_interpret(shape):
    x, y = inputs(shape, "cpu", seed=shape[0])
    call = pl.pallas_call(tpu_kernel(DEPTH),
                          out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                          interpret=True)
    ref = np.asarray(call(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    got = fma_chain_plain(x, y, DEPTH).numpy()
    assert got.dtype == np.float32
    # the chain moved a: the comparison is not of x with itself
    assert np.abs(ref - x.numpy()).max() > 1e-4
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_version():
    _lib.reset_launches()
    x, y = inputs((8, 128), "cpu")
    torch.testing.assert_close(fma_chain(x, y, 25), fma_chain_plain(x, y, 25),
                               rtol=0, atol=0)
    assert _lib.LAUNCHES["fma_chain"] == 0


def test_probe_shapes():
    """The TPU probe's four shapes, then one element per vertex of kernel I
    at 50^3 and 25^3."""
    cases = next(node for node in probe_source().body
                 if isinstance(node, ast.Assign)
                 and node.targets[0].id == "cases")
    tpu = [shape for _, shape in ast.literal_eval(cases.value)]
    assert [shape for _, shape in SHAPES[:4]] == tpu
    vertices = [TetGrid(n, n, n, 100.0, 100.0, 100.0).n_vertices
                for n in (50, 25)]
    assert [int(np.prod(shape)) for _, shape in SHAPES[4:]] == vertices
