"""Is a deep FMA ladder bound by throughput or by latency on this card?

The port's counterpart of ``tools/probes/lanefill_probe.py`` (TPU row 20),
with kernel P (``pfhubbenchmarks_tpu_torch/csrc/fma_chain.cu``): an
unrolled chain of ``depth`` quadratic FMA steps, one thread per element, at
the TPU probe's four shapes and at one thread per vertex of kernel I at
50^3 and 25^3. For each shape it prints the device time of one launch at
``depth`` and ``2 depth`` (``reps`` launches queued behind a sleep kernel,
the minimum of 5 CUDA-event windows), the slope per step, which cancels
the launch cost, the time of ``depth`` steps without it, and the f32
operations per second of the chain against the 67 TFLOP/s of the H100 SXM
data sheet (the rate ``chip_smoke.py`` bounds kernels by).

Usage: python tools/torch_lanefill_probe.py [depth] [reps]
(depth one of 25, 50, 100, 200, 400; default 200 and 100, the TPU probe's).
Needs a CUDA device; it builds the port's kernels at first use.
"""

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfhubbenchmarks_tpu_torch.ops import fma_chain  # noqa: E402

F32_FLOP_PER_S = 67e12


def main(argv) -> None:
    depth = int(argv[0]) if argv else 200
    reps = int(argv[1]) if len(argv) > 1 else 100
    if not torch.cuda.is_available():
        raise SystemExit("torch_lanefill_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    for r in fma_chain.probe(depth, reps):
        print(f"{r['name']}: {r['threads']} threads, {r['chain_ms'] * 1e3:8.3f} "
              f"us for {depth} steps ({r['step_ns']:.3f} ns/step; per launch "
              f"{r['ms_at_depth'] * 1e3:.3f} us at depth {depth}, "
              f"{r['ms_at_2depth'] * 1e3:.3f} us at {2 * depth}), "
              f"{r['flop_per_s'] / 1e12:.2f} TFLOP/s = "
              f"{r['flop_per_s'] / F32_FLOP_PER_S:.3f} of {F32_FLOP_PER_S / 1e12:g}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
