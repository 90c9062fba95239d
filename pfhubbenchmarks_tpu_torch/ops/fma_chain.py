"""Kernel P (``csrc/fma_chain.cu``): the FMA-ladder probe, and the probe
that times it.

Replaces the Pallas kernel of ``tools/probes/lanefill_probe.py`` (TPU row
20), which asked whether a deep FMA ladder is bound by throughput or by
latency. ``fma_chain(x, y, depth)`` runs ``depth`` steps of
``a = a * (1 + a * 1e-12) + y * c_i``, ``c_i = f32(1e-8 * (i % 5 + 1))``,
from ``a = x`` on f32 tensors of any shape; ``fma_chain_plain`` is the same
loop on tensors, which the wrapper takes for CPU tensors only.

``probe`` asks the TPU probe's question of this card: the device time of one
launch at each shape, as the slope between two depths (which cancels the
launch cost), the minimum of several CUDA-event windows at each depth, and
the f32 operations per second that slope gives. ``SHAPES`` are the TPU
probe's four (``lanefill_probe.py:33-38``) and one element per vertex of
kernel I at 50^3 and 25^3.
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.ops import _lib

# the instantiated depths (csrc/fma_chain.cu)
DEPTHS = (25, 50, 100, 200, 400, 800)
# f32 operations of one step: a * 1e-12 + 1 and a * t + y c_i, two FMAs;
# the five products y c_i are formed once per element
OPS_PER_STEP = 4
OPS_PER_ELEMENT = 5
SHAPES = (("padded-L0 [2800,128]", (2800, 128)),
          ("flat-L0 [1000,128]", (1000, 128)),
          ("padded-L1 [800,128]", (800, 128)),
          ("flat-L1 [150,128]", (150, 128)),
          ("kernel I 50^3 [132651]", (51 ** 3,)),
          ("kernel I 25^3 [17576]", (26 ** 3,)))


def _coefficients(depth: int) -> list[float]:
    """c_i as the TPU kernel forms it: the f64 product rounded to f32."""
    return [float(np.float32(1e-8 * (i % 5 + 1))) for i in range(depth)]


def fma_chain_plain(x: torch.Tensor, y: torch.Tensor, depth: int) -> torch.Tensor:
    a = x
    for c in _coefficients(depth):
        a = a * (1.0 + a * 1e-12) + y * c
    return a


def fma_chain_kernel(x: torch.Tensor, y: torch.Tensor, depth: int) -> torch.Tensor:
    if depth not in DEPTHS:
        raise ValueError(f"fma_chain: depth {depth} is not built; have {DEPTHS}")
    _lib.check_cuda("fma_chain", [x, y])
    if x.shape != y.shape:
        raise ValueError(f"fma_chain: shapes {tuple(x.shape)} and {tuple(y.shape)}")
    out = torch.empty_like(x)
    _lib.library().call("pfh_fma_chain", x.data_ptr(), y.data_ptr(),
                        out.data_ptr(), x.numel(), depth, _lib.stream_handle())
    _lib.count_launch("fma_chain")
    return out


def fma_chain(x: torch.Tensor, y: torch.Tensor, depth: int) -> torch.Tensor:
    if _lib.on_cpu(x):
        return fma_chain_plain(x, y, depth)
    return fma_chain_kernel(x, y, depth)


def chain_ops(n: int, depth: int) -> int:
    """f32 operations of one call on ``n`` elements."""
    return n * (OPS_PER_STEP * depth + OPS_PER_ELEMENT)


def inputs(shape, device, seed: int = 0):
    """Seeded x ~ U(0.5, 1.5) and y ~ N(0, 1e3^2), so the y c_i terms move
    a (the TPU probe's ones and halves leave it at 1 in f32)."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(0.5, 1.5, shape), dtype=torch.float32,
                     device=device)
    y = torch.tensor(1e3 * rng.standard_normal(shape), dtype=torch.float32,
                     device=device)
    return x, y


def launch_ms(x, y, depth: int, launches: int, windows: int = 5) -> float:
    """Device time of one launch: ``launches`` launches queued behind a
    sleep kernel, so the card runs them back to back whatever the host's
    launch path costs, between two CUDA events; the minimum over
    ``windows`` windows."""
    fma_chain_kernel(x, y, depth)
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fma_chain_kernel(x, y, depth)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / launches)
    return best


def probe(depth: int = 200, launches: int = 100, device="cuda"):
    """For each of ``SHAPES``: the device time per launch at ``depth`` and
    ``2 depth``, the slope per step, the time of ``depth`` steps without the
    launch cost and the f32 operations per second of the chain. Returns one
    dict per shape."""
    if depth not in DEPTHS or 2 * depth not in DEPTHS:
        raise ValueError(f"probe: depth {depth} and {2 * depth} must be built; "
                         f"have {DEPTHS}")
    out = []
    for name, shape in SHAPES:
        x, y = inputs(shape, device)
        n = x.numel()
        t1 = launch_ms(x, y, depth, launches)
        t2 = launch_ms(x, y, 2 * depth, launches)
        step_ms = (t2 - t1) / depth
        out.append(dict(name=name, shape=list(shape), threads=n, depth=depth,
                        ms_at_depth=t1, ms_at_2depth=t2, step_ns=step_ms * 1e6,
                        chain_ms=step_ms * depth,
                        flop_per_s=OPS_PER_STEP * n / (step_ms * 1e-3)))
    return out


def sass_counts(library_path: Path) -> dict[int, tuple[int, int]]:
    """FFMA and FMUL instructions of each depth's kernel in the built
    library, read with ``cuobjdump -sass`` (beside nvcc): {depth: (ffma,
    fmul)}. A chain that was not folded has at least 2 per step."""
    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts: dict[int, tuple[int, int]] = {}
    depth = None
    for line in text.splitlines():
        m = re.search(r"Function : \S*fma_chain_kernelILi(\d+)E", line)
        if m:
            depth = int(m.group(1))
            counts[depth] = (0, 0)
        elif "Function :" in line:
            depth = None
        elif depth is not None:
            ffma, fmul = counts[depth]
            counts[depth] = (ffma + bool(re.search(r"\bFFMA\b", line)),
                             fmul + bool(re.search(r"\bFMUL\b", line)))
    return counts
