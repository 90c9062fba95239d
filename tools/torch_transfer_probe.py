"""Kernel H's restriction (``csrc/transfer_general.cu`` over
``csrc/transfer.cuh``) in variants of its strip staging, its per-cell gather
and where its chains read the class weights, built apart and timed on the
card.

    python3 tools/torch_transfer_probe.py [--sass]

Each variant rewrites functions of a copy of the sources under the ignored
``pfhubbenchmarks_tpu_torch/_build/transfer_probe/`` (the package's own
build is untouched) and builds ``transfer_general.cu`` alone into a shared
library. Staging (``stage``): ``async``, the strip's floats copied by
``cp.async`` (all in flight, one wait; the kernel's form), or ``loads``, a
load into a register and a store to shared memory per float. Gather
(``gather_cell``): ``direct``, each term reads its fine value and adds its
product at once (the kernel's form), or ``batched``, a cell's 2 R^2 fine
values read into registers first, then the products added in the same
order. Weights: ``shared``, the slot staged in shared memory with the strip
(the kernel's form), or ``constant``, the slot in ``__constant__`` memory
read as constant-bank operands.

Every variant adds the same rounded terms in the same order, so each must
give the plain version's bits (``restrict_general_plain``), which the probe
checks. For each variant and pair (bench3's 175 -> 35 and 35 -> 7, F = 2) it
prints the device microseconds per launch (40 launches queued behind a sleep
kernel, the variants in turns in one call, three rounds), registers and
shared memory (``-Xptxas -v``) and, from ``cuobjdump -sass``, the counts of
shared loads (LDS), constant loads (LDC), global loads (LDG), asynchronous
copies (LDGSTS), FADD and FMUL in ``restrict_general_kernel<5>`` and the
longest run of shared loads with no FADD between them (how far the loads
run ahead of the chain). ``--sass`` also prints that kernel's SASS up to its
first 400 instructions.

Prints the card's name and power limit first and one JSON line last. Needs
a CUDA device.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid  # noqa: E402
from pfhubbenchmarks_tpu_torch.ops import _lib  # noqa: E402
from pfhubbenchmarks_tpu_torch.ops import transfer as kt  # noqa: E402

_HEAD = ("template <int R, int S, class Plane>\n"
         "__device__ __forceinline__ float gather_cell(")
GATHER = {
    "direct": """template <int R, int S, class Plane>
__device__ __forceinline__ float gather_cell(const GenWeights& W, const Plane& v,
                                             const Plane& m, int ci, int cj,
                                             float acc) {
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wv[py][px][S], v(R * ci + py, R * cj + px)));
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wm[py][px][S], m(R * ci + py, R * cj + px)));
  return acc;
}
""",
    "batched": """template <int R, int S, class Plane>
__device__ __forceinline__ float gather_cell(const GenWeights& W, const Plane& v,
                                             const Plane& m, int ci, int cj,
                                             float acc) {
  float a[R][R], b[R][R];
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px) {
      a[py][px] = v(R * ci + py, R * cj + px);
      b[py][px] = m(R * ci + py, R * cj + px);
    }
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wv[py][px][S], a[py][px]));
#pragma unroll
  for (int py = 0; py < R; ++py)
#pragma unroll
    for (int px = 0; px < R; ++px)
      acc = add(acc, mul(W.wm[py][px][S], b[py][px]));
  return acc;
}
""",
}
STAGE = {
    "async": """__device__ __forceinline__ void stage(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, sizeof(float));
}
""",
    "loads": """__device__ __forceinline__ void stage(float* dst, const float* src) {
  *dst = __ldg(src);
}
""",
}
_STAGE_HEAD = "__device__ __forceinline__ void stage("
# text replacements of the kernel's source, then function replacements
WEIGHTS = {
    "shared": ((), ()),
    "constant": (
        (("__device__ GenWeights g_weights[3];",
          "__constant__ GenWeights g_weights[3];"),
         ("const GenWeights& W = sw;",
          "const GenWeights& W = g_weights[(R - 3) / 2];")),
        (("__device__ __forceinline__ void stage_weights(",
          "__device__ __forceinline__ void stage_weights(GenWeights* sw, "
          "int slot) {\n}\n"),)),
}
# (staging, gather, weights); the first is the kernel's own form
VARIANTS = (("async", "direct", "shared"), ("loads", "direct", "shared"),
            ("async", "batched", "shared"), ("async", "direct", "constant"),
            ("loads", "direct", "constant"))
PAIRS = ((175, 35), (35, 7))
F = 2


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def _replace(path, head, body):
    """``body`` in place of the function of ``path`` that starts at
    ``head`` and ends at the next line holding only a closing brace."""
    with open(path) as f:
        text = f.read()
    a = text.index(head)
    b = text.index("\n}\n", a) + 3
    with open(path, "w") as f:
        f.write(text[:a] + body + text[b:])


def _variant(staging, gather, weights):
    """(library path, nvcc command) of a variant."""
    d = os.path.join(str(_lib.BUILD_DIR), "transfer_probe",
                     f"{staging}-{gather}-{weights}")
    src_dir = os.path.join(d, "csrc")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(str(_lib.CSRC), src_dir)
    cu = os.path.join(src_dir, "transfer_general.cu")
    _replace(os.path.join(src_dir, "transfer.cuh"), _HEAD, GATHER[gather])
    _replace(cu, _STAGE_HEAD, STAGE[staging])
    texts, functions = WEIGHTS[weights]
    with open(cu) as f:
        text = f.read()
    for a, b in texts:
        assert text.count(a) == 1, a
        text = text.replace(a, b)
    with open(cu, "w") as f:
        f.write(text)
    for head, body in functions:
        _replace(cu, head, body)
    so = os.path.join(d, "libtransferprobe.so")
    return so, [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, cu]


def sass(so: str):
    """The SASS lines of restrict_general_kernel<5> in ``so``."""
    tool = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    lines, on = [], False
    for ln in text.splitlines():
        if "Function :" in ln:
            on = "restrict_general_kernelILi5E" in ln
        elif on and re.search(r"/\*[0-9a-f]{4}\*/", ln):
            lines.append(ln.strip())
    return lines


def sass_stats(lines):
    ops = []
    for ln in lines:
        tokens = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", ln).split()
        if tokens and tokens[0].startswith("@"):
            tokens = tokens[1:]
        ops.append(tokens[0].split(".")[0] if tokens else "")
    run = best = 0
    for o in ops:
        if o == "LDS":
            run += 1
            best = max(best, run)
        elif o == "FADD":
            run = 0
    return {k: ops.count(k) for k in ("LDS", "LDC", "FADD", "FMUL", "LDG",
                                      "LDGSTS", "BAR")} | {
        "lds_run": best, "instructions": len(ops)}


def main() -> None:
    show_sass = "--sass" in sys.argv[1:]
    print(smi(), flush=True)
    dev = torch.device("cuda", 0)
    builds = {"-".join(v): _variant(*v) for v in VARIANTS}
    procs = {n: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, (_, cmd) in builds.items()}
    libs, out = {}, {"variants": {}}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for n, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{n}: nvcc failed:\n{log[-4000:]}")
        vl = ctypes.CDLL(builds[n][0])
        vl.pfh_transfer_general.argtypes = [i32, i32] + [vp] * 5 + [i32] * 4 + [vp]
        vl.pfh_transfer_general_upload.argtypes = [i32, vp]
        for R in (5,):
            err = vl.pfh_transfer_general_upload(R, kt._general_params(R).ctypes.data)
            if err:
                raise RuntimeError(f"{n}: upload error {err}")
        libs[n] = vl
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln]
        stats = sass_stats(sass(builds[n][0]))
        out["variants"][n] = {"ptxas": used, "sass": stats}
        print(f"{n}: built; {' | '.join(used)}; SASS of "
              f"restrict_general_kernel<5>: {stats}", flush=True)
        if show_sass:
            for ln in sass(builds[n][0])[:400]:
                print(f"{n} sass| {ln}")
    rng = np.random.default_rng(5)
    for nf, nc in PAIRS:
        fine, coarse = (CrossedTriGrid(n, n, 960.0, 960.0) for n in (nf, nc))
        wf = tuple(torch.tensor(rng.standard_normal((F,) + s), dtype=torch.float32,
                                device=dev) for s in (fine.vshape, fine.mshape))
        ref = kt.restrict_general_plain(wf, coarse, fine)
        dst = tuple(torch.empty((F,) + s, device=dev)
                    for s in (coarse.vshape, coarse.mshape))
        key = f"{nf}->{nc}"
        times = {n: [] for n in libs}
        for rep in range(3):
            for n, vl in libs.items():
                def launch(vl=vl):
                    err = vl.pfh_transfer_general(
                        1, nf // nc, wf[0].data_ptr(), wf[1].data_ptr(),
                        dst[0].data_ptr(), dst[1].data_ptr(), None, F, coarse.ny,
                        coarse.nx, 0, _lib.stream_handle())
                    if err:
                        raise RuntimeError(f"{n}: launch error {err}")
                times[n].append(_lib.device_ms(launch) * 1e3)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(dst, ref)):
                    raise AssertionError(f"{n} {key}: not the plain version's bits")
        for n, t in times.items():
            out["variants"][n][key] = t
            print(f"{n} {key}: restriction device us per launch {t} "
                  f"(bit-identical to the plain version)", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
