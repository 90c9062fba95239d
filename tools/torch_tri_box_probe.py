"""Kernel W (the triangle-box J.v, ``csrc/fem_tri_box.cuh``) and the residual
box built with other box shapes, on this card.

    python3 tools/torch_tri_box_probe.py [ch|chac|ach|acha|chp|rchac|rchp|all]
                                                              (default all)

Each variant rewrites the ``TriBox<BY, BX, MIN_CTAS, QSPLIT>`` line of
``csrc/ch_box.cu`` (W at BM1's physics), ``csrc/chac_box.cu`` (BM2's
coupled physics), ``csrc/ach_box.cu`` (BM3's), ``csrc/acha_box.cu`` (the
anisotropic BM3's), ``csrc/chp_box.cu`` (BM6's, with its Dirichlet mask),
``csrc/chac_rbox.cu`` (the
residual box at BM2's) or ``csrc/chp_rbox.cu`` (at BM6's) in a copy of the
sources under the ignored ``pfhubbenchmarks_tpu_torch/_build/tri_box_probe/``
(the package's own build is untouched) and builds that source alone into a
shared library, all variants in parallel. Each is held against the gather
kernel it replaces (A at bench1 100^2, F at bench2 100^2 with 4 order
parameters, G at bench3 350^2, the anisotropic gather at the anisotropic
bench3's 350^2, E at bench6 100^2 with its Dirichlet rows, all at ffc3; R
at bench2 100^2 with 4 order
parameters and at bench6 100^2 with its Dirichlet rows) with
``torch.equal``, and timed per launch (40 launches queued behind a sleep
kernel) beside the gather kernel and, for a J.v with a tile form, T10 in
the same call, in
turns; with each shape's CTAs, recompute factor (evaluated cells over the
grid's), registers, spills, shared bytes and CTAs per SM.

Prints the card's name and power limit first and one JSON line last. Needs
a CUDA device; it builds the port's kernels at first use.
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

from pfhubbenchmarks_tpu_torch.ops import _lib  # noqa: E402

# (BY, BX, MIN_CTAS, QSPLIT) per kind; the first is the package's
SHAPES = {"ch": ((7, 7, 2, 2), (7, 7, 2, 1), (7, 7, 4, 1), (7, 7, 1, 4),
                 (3, 7, 4, 1), (3, 7, 4, 2), (5, 5, 4, 1), (3, 3, 8, 1),
                 (3, 3, 4, 2), (7, 15, 2, 1)),
          "chac": ((7, 7, 2, 1), (7, 7, 1, 2), (3, 7, 2, 2), (3, 7, 1, 4),
                   (3, 3, 2, 4), (3, 3, 1, 4), (1, 7, 2, 4)),
          "ach": ((7, 15, 3, 1), (7, 15, 2, 1), (7, 15, 4, 1), (7, 7, 6, 1),
                  (7, 7, 8, 1), (3, 15, 3, 2), (3, 7, 3, 4), (7, 15, 1, 2)),
          "acha": ((7, 15, 3, 1), (7, 15, 2, 1), (7, 15, 4, 1), (7, 7, 6, 1),
                   (7, 7, 4, 1), (3, 15, 3, 2), (7, 15, 1, 2)),
          "chp": ((7, 7, 2, 2), (7, 7, 2, 1), (7, 7, 4, 1), (7, 7, 1, 4),
                  (3, 7, 4, 2), (5, 5, 4, 1), (3, 3, 4, 2), (7, 15, 2, 1)),
          "rchac": ((7, 7, 2, 1), (7, 7, 1, 2), (3, 7, 2, 2), (5, 5, 2, 1),
                    (3, 3, 2, 4)),
          "rchp": ((7, 7, 2, 1), (7, 7, 4, 1), (7, 7, 2, 2), (3, 7, 4, 2),
                   (5, 5, 4, 1), (3, 3, 4, 2))}
SOURCE = {"ch": "ch_box.cu", "chac": "chac_box.cu", "ach": "ach_box.cu",
          "acha": "acha_box.cu", "chp": "chp_box.cu",
          "rchac": "chac_rbox.cu", "rchp": "chp_rbox.cu"}
ALIAS = {"ch": "ChBox", "chac": "ChacBox", "ach": "AchBox", "acha": "AchaBox",
         "chp": "ChpBox", "rchac": "ChacRBox", "rchp": "ChpRBox"}
# the launcher's symbol and its int arguments before the box per kind
SYMBOL = {"ch": "pfh_ch_box", "chac": "pfh_chac_box", "ach": "pfh_ach_box",
          "acha": "pfh_acha_box", "chp": "pfh_chp_box",
          "rchac": "pfh_chac_rbox", "rchp": "pfh_chp_rbox"}
# the benchmark each kind is probed on, its dt
BENCH = {"ch": ("bench1", 0.5), "chac": ("bench2", 0.16),
         "ach": ("bench3", 1.28), "acha": ("bench3", 1.28),
         "chp": ("bench6", 0.32),
         "rchac": ("bench2", 0.16), "rchp": ("bench6", 0.32)}
# the benchmark's options per kind
OPTIONS = {"acha": dict(anisotropy=True)}
# the kinds with a tile form (T10) to time beside
TILED = ("ch", "chac", "ach")


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def variant_build(kind, shape):
    """(library path, nvcc command): csrc with the box line of
    ``SOURCE[kind]`` rewritten to ``shape``, that source alone built into a
    shared library."""
    by, bx, mc, qs = shape
    d = os.path.join(str(_lib.BUILD_DIR), "tri_box_probe",
                     f"{kind}_{by}x{bx}_{mc}_{qs}")
    src_dir = os.path.join(d, "csrc")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(str(_lib.CSRC), src_dir)
    p = os.path.join(src_dir, SOURCE[kind])
    text, n = re.subn(
        rf"using {ALIAS[kind]} = pfh::TriBox<\d+, \d+, \d+, \d+>;",
        f"using {ALIAS[kind]} = pfh::TriBox<{by}, {bx}, {mc}, {qs}>;",
        open(p).read())
    assert n == 1, kind
    with open(p, "w") as f:
        f.write(text)
    so = os.path.join(d, "libtribox.so")
    # -fno-gnu-unique: each variant keeps its own function-local statics
    # (the once-only shared-memory attribute)
    return so, [_lib._nvcc(), *_lib.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
                "-shared", "-o", so, p]


def probe(kinds, out: dict) -> None:
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import get_benchmark

    _lib.library()
    dev = torch.device("cuda", 0)
    builds = [(k, s, *variant_build(k, s)) for k in kinds for s in SHAPES[k]]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for *_, cmd in builds]
    libs = {}
    vp, i32, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    for (kind, shape, so, _), proc in zip(builds, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{kind} {shape}: nvcc failed:\n{log[-4000:]}")
        vl = ctypes.CDLL(so)
        ne = kind.endswith("chac")   # the launcher takes ne before the box
        # a J.v box takes the mask after b, the residual box mask and g first
        planes = 8 if kind.startswith("r") else 9
        getattr(vl, SYMBOL[kind]).argtypes = (
            [vp] + [i32] * (4 if ne else 3) + [vp] * planes + [i32, i32, vp])
        getattr(vl, SYMBOL[kind] + "_info").argtypes = [i32, ip] if ne else [ip]
        libs[(kind, shape)] = vl
        print(f"{kind} {shape}: built; " + " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln),
              flush=True)
    rng = np.random.default_rng(14)
    res = []
    for kind in kinds:
        name, dt = BENCH[kind]
        pb = get_benchmark(name, **OPTIONS.get(kind, {}))
        g, F = pb.grid, pb.n_fields
        v0, m0 = g.interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a + 0.01 * rng.standard_normal(a.shape),
                               dtype=torch.float32, device=dev) for a in (v0, m0))
        for bc in pb.dirichlet:
            w = (bc.apply_value(w[0]).contiguous(), w[1])
        v = tuple(torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32,
                               device=dev) for t in w)
        fns = {}
        if kind.startswith("r"):
            # the residual box at (w, w0 = the IC plus other noise)
            w0 = tuple((t + 0.01 * x).contiguous() for t, x in zip(w, v))
            rr = pb.kernel_residual(g, dev, pb.dirichlet, form="box")
            plan, ref = rr.plan, rr.gather.kernel(w, w0, dt)
            fns["gather"] = lambda: rr.gather.kernel(w, w0, dt)
            mask, gv = (None if t is None else t.data_ptr()
                        for t in plan.planes)
            ops = (w[0], w[1], w0[0], w0[1])
            extra = (mask, gv)
        else:
            jv = pb.kernel_jvp(g, dev, pb.dirichlet, form="box")
            plan, ref = jv.plan, jv.gather.kernel(w, w, dt, v)
            fns["gather"] = lambda: jv.gather.kernel(w, w, dt, v)
            if kind in TILED:
                t10 = pb.kernel_jvp(g, dev, form="recompute")
                fns["T10"] = lambda: t10.kernel(w, w, dt, v)
            ops = (w[0], w[1], v[0], v[1])
            extra = (None, None, None if plan.mask is None
                     else plan.mask.data_ptr())
        params = plan.params.copy()
        params[-1] = dt
        variant = plan.variant
        outs = {}
        for shape in SHAPES[kind]:
            vl = libs[(kind, shape)]
            o = (torch.empty_like(w[0]), torch.empty_like(w[1]))
            fn = getattr(vl, SYMBOL[kind])

            def run(fn=fn, o=o, shape=shape):
                err = fn(params.ctypes.data, 4, *variant, shape[0], shape[1],
                         *(t.data_ptr() for t in ops), *extra, o[0].data_ptr(),
                         o[1].data_ptr(), g.ny, g.nx, _lib.stream_handle())
                if err:
                    raise RuntimeError(f"{kind} {shape}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            outs[shape] = o
            fns[shape] = run
        rounds = [{k: _lib.device_ms(fn) * 1e3 for k, fn in fns.items()}
                  for _ in range(2)]
        us = {k: sum(r[k] for r in rounds) / 2 for k in fns}
        t10_us = us.get("T10")
        print(f"{kind}: device us {pb.name} {g.ny}x{g.nx} ffc3: gather "
              f"{us['gather']:.2f}"
              + (f", T10 {t10_us:.2f}" if t10_us else ""), flush=True)
        for shape in SHAPES[kind]:
            vl = libs[(kind, shape)]
            info = (ctypes.c_int * 5)()
            getattr(vl, SYMBOL[kind] + "_info")(*variant, info)
            by, bx = shape[:2]
            boxes = ((g.ny + by) // by) * ((g.nx + bx) // bx)
            rf = 1.0
            for n, b in ((g.ny, by), (g.nx, bx)):
                rf *= sum(min(o_ + b, n) - max(o_ - 1, 0)
                          for o_ in range(0, n + 1, b)) / n
            bits = all(torch.equal(a, b) for a, b in zip(outs[shape], ref))
            row = dict(kind=kind, shape=shape, us=us[shape],
                       rounds=[r[shape] for r in rounds], gather_us=us["gather"],
                       t10_us=t10_us, boxes=boxes, recompute=rf, bits=bits,
                       registers=info[0], local_bytes=info[1],
                       dynamic_smem=info[3], ctas_per_sm=info[4])
            res.append(row)
            print(f"{kind} {shape}: {us[shape]:.2f} us per launch (gather "
                  f"{us['gather']:.2f}"
                  + (f", T10 {t10_us:.2f}" if t10_us else "")
                  + f"); {boxes} CTAs, "
                  f"recompute {rf:.3f}, {info[0]} registers, {info[1]} local "
                  f"bytes, {info[3]} B shared, {info[4]} CTAs/SM; "
                  f"{'bit-identical to the gather' if bits else 'DIFFERS'}",
                  flush=True)
            if not bits:
                raise AssertionError(f"{kind} {shape} differs from the gather")
    out["tri_box"] = res


def main(argv) -> None:
    mode = argv[0] if argv else "all"
    if mode not in (*SHAPES, "all"):
        raise SystemExit(f"torch_tri_box_probe: unknown mode {mode!r}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_tri_box_probe: no CUDA device")
    print(smi(), flush=True)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi()}
    probe(tuple(SHAPES) if mode == "all" else (mode,), out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
