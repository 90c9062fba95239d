"""The barriers of a cooperative launch with a thread-block cluster dimension,
on this card.

    python3 tools/torch_cluster_probe.py

Builds ``tools/torch_cluster_probe.cu`` alone into the ignored
``pfhubbenchmarks_tpu_torch/_build/cluster_probe/`` and, for clusters of C =
1, 2, 4, 8 and 16 CTAs of 256 threads with 120 KB of dynamic shared memory
each (one CTA per SM, as a kernel of more than 128 registers):

- the co-resident clusters (``cudaOccupancyMaxActiveClusters``) and so the
  largest grid a cooperative launch of that cluster size may take;
- whether ``cudaLaunchKernelEx`` takes the launch with both
  ``cudaLaunchAttributeClusterDimension`` and
  ``cudaLaunchAttributeCooperative`` (the CUDA error where it does not);
- the device microseconds of one grid barrier over that grid and of one
  cluster barrier on cluster 0, from launches of 0 and 2,000 barriers
  (CUDA events, median of 5), and of one grid barrier over grids of C CTAs.

Prints the card's name and power limit first and one JSON line last. Needs
a CUDA device.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pfhubbenchmarks_tpu_torch.ops import _lib  # noqa: E402

SMEM = 120 * 1024
N = 2000


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build() -> ctypes.CDLL:
    out = os.path.join(ROOT, "pfhubbenchmarks_tpu_torch", "_build",
                       "cluster_probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libcluster_probe.so")
    cu = os.path.join(ROOT, "tools", "torch_cluster_probe.cu")
    proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_max_clusters.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.probe_launch.argtypes = [i32] * 6 + [vp, vp]
    return lib


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_cluster_probe: no CUDA device")
    print(smi(), flush=True)
    lib = build()
    sink = torch.zeros(132 * 256 * 2, device="cuda")
    stream = _lib.stream_handle()
    rows = []

    def run_ms(grid, c, n_grid, n_cluster):
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = lib.probe_launch(grid, c, 1, SMEM, n_grid, n_cluster,
                                   sink.data_ptr(), stream)
            b.record()
            b.synchronize()
            if err != 0:
                raise RuntimeError(f"launch grid {grid} cluster {c}: CUDA "
                                   f"error {err}")
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    for c in (1, 2, 4, 8, 16):
        n = ctypes.c_int(0)
        err = lib.probe_max_clusters(c, SMEM, ctypes.byref(n))
        row = dict(cluster=c, max_clusters=n.value, occupancy_error=err)
        if err == 0 and n.value > 0:
            grid = n.value * c
            err = lib.probe_launch(grid, c, 1, SMEM, 0, 0, sink.data_ptr(),
                                   stream)
            torch.cuda.synchronize()
            row.update(grid=grid, launch_error=err)
            if err == 0:
                base = run_ms(grid, c, 0, 0)
                row["grid_barrier_us"] = (run_ms(grid, c, N, 0) - base) / N * 1e3
                row["cluster_barrier_us"] = (run_ms(grid, c, 0, N) - base) / N * 1e3
                small = run_ms(c, c, 0, 0)
                row["grid_barrier_us_on_c_ctas"] = (
                    run_ms(c, c, N, 0) - small) / N * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi(),
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
