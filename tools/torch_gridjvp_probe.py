"""BM3's J.v as a row-block grid that scatters into per-block slabs, on this
card.

The port's counterpart of ``tools/probes/gridjvp_probe.py`` (TPU row 19),
with kernel Q (``pfhubbenchmarks_tpu_torch/csrc/gridjvp_probe.cu``): bench3
at 350^2 (F = 2, f32) as 7 row blocks of 50 cell rows, each writing its own
partial vertex slab and its cell rows; a fold adds the slabs. It prints the
norm of the centre output (as the TPU probe does), for case a (and c) the
folded result against the full-grid J.v of kernel G and of
``torch.func.jvp`` of the f32 residual (max abs errors, rtol 2e-4, atol
2e-5 x max|ref|), and the device microseconds per launch of Q, its fold,
kernel G and the tile kernel T12 at the same shape (40 launches queued
behind a sleep kernel).

Cases: a, BM3's pointwise tangent; b, identity physics (source z, flux
grad z); c, the TPU probe's jax.jvp of the whole block assembly, the same
function as a: CUDA has no in-kernel AD, so c runs a's body.

Usage: python tools/torch_gridjvp_probe.py [a|b|c]   (default a)
Needs a CUDA device; it builds the port's kernels at first use.
"""

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pfhubbenchmarks_tpu_torch.ops import gridjvp  # noqa: E402


def main(argv) -> None:
    case = argv[0] if argv else "a"
    if not torch.cuda.is_available():
        raise SystemExit("torch_gridjvp_probe: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if gridjvp.body_case(case) != case:
        print(f"gridjvp[{case}]: runs case {gridjvp.body_case(case)}'s body "
              "(CUDA has no in-kernel AD; the TPU's jax.jvp of the whole block "
              "assembly is the same function)", flush=True)
    out = gridjvp.probe(case, device="cuda")
    print(f"gridjvp[{case}]: COMPILED AND RAN, {out['blocks']} blocks of "
          f"{out['br']} rows, out_m norm={out['out_m_norm']:.6g}", flush=True)
    for ref in ("kernel G", "torch.func.jvp"):
        if ref in out:
            r = out[ref]
            print(f"gridjvp[{case}] vs {ref}: err_v={r['err_v']:.3e} "
                  f"err_m={r['err_m']:.3e} scale={out['scale']:.3g} "
                  f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
    print("device us per launch: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["device_us"].items()), flush=True)
    print(json.dumps(out), flush=True)
    if not all(out[ref]["ok"] for ref in ("kernel G", "torch.func.jvp")
               if ref in out):
        raise SystemExit(1)


if __name__ == "__main__":
    main(sys.argv[1:])
