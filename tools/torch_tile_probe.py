"""Why the 2D tile J.v (T12) gained only 1.4x over the gather J.v (G), and
the box shape of the 3D tile J.v (U), on this card.

    python3 tools/torch_tile_probe.py [t12|box|bound|all] [--no-ncu]
                                                              (default all)

``t12``: bench3's J.v at 350^2 (F = 2, the AC + heat tangent) at dunavant2
(3 points, the levels' rule) and ffc3 (4 points), for kernel G
(``csrc/ach_jvp.cu``, one thread per node) and T12 (``csrc/ach_tile.cu``,
the seam form: one thread per cell of an 8x16 tile, then a fold). For each:
registers, spills and shared memory per CTA (``cudaFuncGetAttributes``, and
the ``-Xptxas -v`` lines of the build), co-resident CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the waves of the
launch, threads launched, tangent evaluations and row contractions per
thread, and the device microseconds per launch (40 launches queued behind a
sleep kernel, both kernels in the same call). The time at 3 and 4 points
splits each kernel's launch into a fixed part (the intercept at 0 points:
staging, barriers, the fold, the gradients) and a part per point (the
slope). Whether ``ncu`` is in the toolkit is printed; where it is, one
launch of each is profiled with ``--section SpeedOfLight,Occupancy,
WarpStateStats``.

``box``: kernel U (``csrc/fem_tet_tile.cuh``) built with other box shapes
(the ``kBoxX/Y/Z`` lines rewritten in a copy of the sources under the
ignored ``pfhubbenchmarks_tpu_torch/_build/tet_box_probe/``; the package's
own build is untouched), each held against the plain version (rtol 2e-4,
atol 2e-5 x max|ref|) and timed per launch at bench1_3d's keast2 50^3 and
25^3 and ffc3 50^3, beside kernel I in the same call; with each shape's
recompute factor, CTAs, registers and shared memory.

``bound``: kernel U at bench6_3d's physics (``csrc/chp3d_tile.cu``, CHP3
with the Dirichlet mask) built alone with each launch bound of
``BOUND_CTAS`` at 8 points (``-DPFH_CHP3D_MIN_CTAS=n``, under the ignored
``_build/tet_bound_probe/``), each held against the package's U (the bits)
and its plain version, and timed per launch at bench6_3d's ffc3 50^3 and
25^3 with the mask, the variants in turns in two rounds; with each one's
registers, spill bytes and CTAs per SM and its ptxas lines.

Prints the card's name and power limit first and one JSON line last. Needs
a CUDA device; it builds the port's kernels at first use.
"""

import ctypes
import dataclasses
import json
import math
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

# box shapes (x, y, z) of the sweep; the first is the package's
BOX_SHAPES = ((7, 7, 7), (8, 8, 5), (8, 8, 6), (15, 7, 3), (16, 8, 4), (8, 4, 4))
# kernel U's CTAs per SM at 8 points at BM6's physics (phys_chp3d.cuh
# PFH_CHP3D_MIN_CTAS) of the ``bound`` sweep
BOUND_CTAS = (1, 2, 3)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def ptxas_lines(lib, source: str) -> list[str]:
    out, src = [], ""
    for ln in lib.build_log.splitlines():
        if ln.startswith("== "):
            src = ln[3:]
        elif src == source and ("Used" in ln or "spill" in ln
                                or "Compiling entry" in ln):
            out.append(ln.strip())
    return out


def ncu_path() -> str | None:
    for p in (shutil.which("ncu"), "/usr/local/cuda/bin/ncu"):
        if p and os.path.exists(p):
            return p
    return None


def t12(out: dict, run_ncu: bool = True) -> None:
    from pfhubbenchmarks_tpu_torch.benchmarks import bench3

    lib = _lib.library()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pb = bench3.make()
    rng = np.random.default_rng(7)
    res = {}
    for rule, nq in (("dunavant2", 3), ("ffc3", 4)):
        g = dataclasses.replace(pb.grid, rule_name=rule)
        v0, m0 = g.interpolate(pb.ic_fns)
        w = tuple(torch.tensor(a + 0.01 * rng.standard_normal(a.shape),
                               dtype=torch.float32, device=dev) for a in (v0, m0))
        v = tuple(torch.tensor(rng.standard_normal(a.shape), dtype=torch.float32,
                               device=dev) for a in (v0, m0))
        jg, jt = pb.kernel_jvp(g, dev), pb.kernel_jvp(g, dev, form="seam")
        dt = 1.28
        a, b = jg.kernel(w, w, dt, v), jt.kernel(w, w, dt, v)
        err = max(float((x - y).abs().max()) for x, y in zip(a, b))
        scale = max(float(x.abs().max()) for x in a)
        us = {"G": _lib.device_ms(lambda: jg.kernel(w, w, dt, v)) * 1e3,
              "T12": _lib.device_ms(lambda: jt.kernel(w, w, dt, v)) * 1e3}
        us["G again"] = _lib.device_ms(lambda: jg.kernel(w, w, dt, v)) * 1e3
        nodes = (g.ny + 1) * (g.nx + 1) + g.ny * g.nx
        ig = lib.kernel_info("pfh_ach_jvp_info", nq)
        it = lib.kernel_info("pfh_ach_tile_info", 1, nq)
        # T12: one CTA of 128 threads per 8x16-cell tile (fem_tile.cuh)
        ctas = {"G": math.ceil(nodes / 128),
                "T12": math.ceil(g.ny / 8) * math.ceil(g.nx / 16)}
        threads = {"G": ctas["G"] * 128, "T12": ctas["T12"] * 128}
        info = {"G": ig, "T12": it}
        case = {"nq": nq, "G vs T12 max abs diff": err, "max|G|": scale,
                "device_us": us}
        for k in ("G", "T12"):
            resident = info[k]["ctas_per_sm"] * sms
            case[k] = dict(info[k], ctas=ctas[k], threads=threads[k],
                           resident_ctas=resident,
                           waves=ctas[k] / resident)
        # per thread: a vertex of G sums its 8 triangles, a centre its 4,
        # each triangle's tangent at every point into its own row; a T12
        # thread evaluates its cell's 4 triangles once, each into 3 rows
        case["G"].update(tangent_evals_per_thread={"vertex": 8 * nq,
                                                   "centre": 4 * nq},
                         row_contractions_per_thread={"vertex": 8 * nq,
                                                      "centre": 4 * nq})
        case["T12"].update(tangent_evals_per_thread=4 * nq,
                           row_contractions_per_thread=12 * nq)
        cells = g.ny * g.nx
        case["tangent_evals_total"] = {
            "G": ((g.ny + 1) * (g.nx + 1) * 8 + cells * 4) * nq,
            "T12": cells * 4 * nq}
        case["row_contractions_total"] = {
            "G": case["tangent_evals_total"]["G"], "T12": cells * 12 * nq}
        res[rule] = case
        print(f"t12 {rule} ({nq} points) 350^2: G {us['G']:.2f} us "
              f"({us['G again']:.2f} again), T12 {us['T12']:.2f} us per launch; "
              f"G {ig}, {ctas['G']} CTAs, waves {case['G']['waves']:.2f}; "
              f"T12 {it}, {ctas['T12']} CTAs, waves {case['T12']['waves']:.2f}; "
              f"tangent evaluations {case['tangent_evals_total']}, row "
              f"contractions {case['row_contractions_total']}; G vs T12 max "
              f"abs diff {err:.3e} (max|G| {scale:.3e})", flush=True)
    # the fixed part and the part per point of each kernel's launch
    fit = {}
    for k in ("G", "T12"):
        t3 = res["dunavant2"]["device_us"][k]
        t4 = res["ffc3"]["device_us"][k]
        fit[k] = {"per_point_us": t4 - t3, "fixed_us": t3 - 3 * (t4 - t3)}
        print(f"t12 fit {k}: {t4 - t3:.3f} us per point, {fit[k]['fixed_us']:.3f} "
              "us at 0 points", flush=True)
    res["fit"] = fit
    for src in ("ach_jvp.cu", "ach_tile.cu"):
        for ln in ptxas_lines(lib, src):
            print(f"t12 ptxas {src}: {ln}", flush=True)
    ncu = ncu_path()
    res["ncu"] = ncu
    print(f"t12 ncu: {ncu or 'not in the toolkit (no ncu on PATH or under /usr/local/cuda/bin)'}",
          flush=True)
    if ncu and run_ncu:
        # one launch of each of G and T12 (the first two that match)
        cmd = [ncu, "--section", "SpeedOfLight", "--section", "Occupancy",
               "--section", "WarpStateStats", "-k",
               "regex:fem_(jvp|tile)_kernel", "-c", "2", sys.executable,
               os.path.abspath(__file__), "t12", "--no-ncu"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            res["ncu_rc"] = proc.returncode
            text = proc.stdout + proc.stderr
        except subprocess.TimeoutExpired as e:
            res["ncu_rc"] = "timeout"
            text = str(e)
        for ln in text.splitlines()[-80:]:
            print(f"t12 ncu| {ln}", flush=True)
    out["t12"] = res


def _variant_build(shape):
    """(library, nvcc command): csrc with kBoxX/Y/Z rewritten,
    ch3d_tile.cu alone built into a shared library under
    _build/tet_box_probe/."""
    x, y, z = shape
    d = os.path.join(str(_lib.BUILD_DIR), "tet_box_probe", f"{x}x{y}x{z}")
    src_dir = os.path.join(d, "csrc")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(str(_lib.CSRC), src_dir)
    p = os.path.join(src_dir, "fem_tet_tile.cuh")
    text = open(p).read()
    for name, val in (("kBoxX", x), ("kBoxY", y), ("kBoxZ", z)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {val};", text)
        assert n == 1, name
    with open(p, "w") as f:
        f.write(text)
    # -fno-gnu-unique: each variant keeps its own function-local statics
    # (the once-only shared-memory attribute), which the dynamic linker
    # would otherwise unify across the variants' libraries
    return os.path.join(d, "libtetbox.so"), [
        _lib._nvcc(), *_lib.NVCC_FLAGS, "-Xcompiler", "-fno-gnu-unique",
        "-shared", "-o",
        os.path.join(d, "libtetbox.so"), os.path.join(src_dir, "ch3d_tile.cu")]


def box(out: dict) -> None:
    from pfhubbenchmarks_tpu_torch.benchmarks import bench1_3d
    from pfhubbenchmarks_tpu_torch.ops.fem_jvp3d import with_dt3

    lib = _lib.library()
    dev = torch.device("cuda", 0)
    builds = [(s, *_variant_build(s)) for s in BOX_SHAPES]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _, _, cmd in builds]
    libs = {}
    for (shape, so, _), proc in zip(builds, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"box {shape}: nvcc failed:\n{log[-4000:]}")
        vl = ctypes.CDLL(so)
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        vl.pfh_ch3d_tile.argtypes = [vp, i32] + [vp] * 5 + [i32] * 3 + [vp]
        vl.pfh_ch3d_tile_info.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        libs[shape] = vl
        print(f"box {shape}: built; " + " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln), flush=True)
    pb = bench1_3d.make()
    rng = np.random.default_rng(11)
    res = []
    dt = 0.4
    for rule, n in (("keast2", 50), ("ffc3", 50), ("keast2", 25)):
        g = dataclasses.replace(pb.grid, nx=n, ny=n, nz=n, rule_name=rule)
        (v0,) = g.interpolate(pb.ic_fns)
        w = (torch.tensor(v0 + 0.01 * rng.standard_normal(v0.shape),
                          dtype=torch.float32, device=dev),)
        v = (torch.tensor(rng.standard_normal(v0.shape), dtype=torch.float32,
                          device=dev),)
        jv = pb.kernel_jvp(g, dev)
        ref = jv.plain(w, w, dt, v)[0]
        params = with_dt3(jv.launch.head, dt, "box probe")
        i_us = _lib.device_ms(lambda: jv.gather(w, w, dt, v)) * 1e3
        for shape, vl in libs.items():
            o = torch.empty_like(v[0])

            def run(vl=vl, o=o):
                err = vl.pfh_ch3d_tile(params.ctypes.data, jv.launch.nq,
                                       w[0].data_ptr(), v[0].data_ptr(), None,
                                       None, o.data_ptr(), n, n, n,
                                       _lib.stream_handle())
                if err:
                    raise RuntimeError(f"box {shape}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            ok = torch.allclose(o, ref, rtol=2e-4, atol=2e-5 * max(scale, 1.0))
            us = _lib.device_ms(run) * 1e3
            info = (ctypes.c_int * 5)()
            vl.pfh_ch3d_tile_info(jv.launch.nq, info)
            boxes = math.prod(math.ceil((n + 1) / b_) for b_ in shape)
            rf = 1.0
            for b_ in shape:
                cells = sum(min(o_ + b_, n) - max(o_ - 1, 0)
                            for o_ in range(0, n + 1, b_))
                rf *= cells / n
            row = dict(shape=shape, rule=rule, n=n, us=us, gather_us=i_us,
                       boxes=boxes, recompute=rf,
                       max_abs_err=float((o - ref).abs().max()), ok=ok,
                       registers=info[0], local_bytes=info[1],
                       dynamic_smem=info[3], ctas_per_sm=info[4])
            res.append(row)
            print(f"box {shape} {rule} {n}^3: {us:.2f} us per launch (I "
                  f"{i_us:.2f}); {boxes} CTAs, recompute {rf:.3f}, "
                  f"{info[0]} registers, {info[1]} local bytes, "
                  f"{info[3]} B shared, {info[4]} CTAs/SM; max abs err "
                  f"{row['max_abs_err']:.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"box {shape} disagrees with the plain version")
    out["box"] = res


def bound(out: dict) -> None:
    from pfhubbenchmarks_tpu_torch.benchmarks import bench6_3d
    from pfhubbenchmarks_tpu_torch.ops.fem_jvp3d import with_dt3

    _lib.library()
    dev = torch.device("cuda", 0)
    builds = {}
    for n in BOUND_CTAS:
        d = os.path.join(str(_lib.BUILD_DIR), "tet_bound_probe", str(n))
        os.makedirs(d, exist_ok=True)
        so = os.path.join(d, "libtetbound.so")
        # -fno-gnu-unique: each variant keeps its own function-local statics
        builds[n] = (so, subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, f"-DPFH_CHP3D_MIN_CTAS={n}",
             "-Xcompiler", "-fno-gnu-unique", "-shared", "-o", so,
             os.path.join(str(_lib.CSRC), "chp3d_tile.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, ptxas = {}, {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for n, (so, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"bound {n}: nvcc failed:\n{log[-4000:]}")
        vl = ctypes.CDLL(so)
        vl.pfh_chp3d_tile.argtypes = [vp, i32] + [vp] * 5 + [i32] * 3 + [vp]
        vl.pfh_chp3d_tile_info.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
        libs[n] = vl
        ptxas[n] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
        print(f"bound {n}: built; " + " | ".join(ptxas[n]), flush=True)
    pb = bench6_3d.make()
    rng = np.random.default_rng(19)
    dt = 0.32
    res = []
    for size in (50, 25):
        g = dataclasses.replace(pb.grid, nx=size, ny=size, nz=size)
        w = pb.initial_state(dev)
        if size != 50:
            from pfhubbenchmarks_tpu_torch.solve import transfer3d as t3

            w = t3.inject3d_any(g, pb.grid)(w)
        w = (w[0].float() + 0.01 * torch.tensor(
            rng.standard_normal(w[0].shape), dtype=torch.float32, device=dev),)
        v = (torch.tensor(rng.standard_normal(w[0].shape), dtype=torch.float32,
                          device=dev),)
        jv = pb.kernel_jvp(g, dev, pb.dirichlet_for(g))
        ref = jv.plain(w, w, dt, v)[0]
        pkg = jv.kernel(w, w, dt, v)[0]
        params = with_dt3(jv.launch.head, dt, "bound probe")
        outs = {n: torch.empty_like(v[0]) for n in libs}

        def run(n):
            err = libs[n].pfh_chp3d_tile(
                params.ctypes.data, jv.launch.nq, w[0].data_ptr(),
                v[0].data_ptr(), None, jv.launch.mask.data_ptr(),
                outs[n].data_ptr(), size, size, size, _lib.stream_handle())
            if err:
                raise RuntimeError(f"bound {n}: CUDA error {err}")

        us = {n: [] for n in libs}
        for _ in range(2):
            for n in libs:
                us[n].append(_lib.device_ms(lambda n=n: run(n)) * 1e3)
        scale = float(ref.abs().max())
        for n, vl in libs.items():
            run(n)
            torch.cuda.synchronize()
            info = (ctypes.c_int * 5)()
            vl.pfh_chp3d_tile_info(jv.launch.nq, info)
            row = dict(min_ctas=n, n=size, us=us[n],
                       same_bits_as_package=bool(torch.equal(outs[n], pkg)),
                       ok=bool(torch.allclose(outs[n], ref, rtol=2e-4,
                                              atol=2e-5 * max(scale, 1.0))),
                       registers=info[0], local_bytes=info[1],
                       ctas_per_sm=info[4], ptxas=ptxas[n])
            res.append(row)
            print(f"bound {n} ffc3 {size}^3: {us[n][0]:.2f} / {us[n][1]:.2f} "
                  f"us per launch; {info[0]} registers, {info[1]} local bytes, "
                  f"{info[4]} CTAs/SM; bits of the package's U "
                  f"{row['same_bits_as_package']}; plain "
                  f"{'ok' if row['ok'] else 'FAIL'}", flush=True)
            if not row["ok"]:
                raise AssertionError(f"bound {n} disagrees with the plain "
                                     "version")
    out["bound"] = res


def main(argv) -> None:
    mode = argv[0] if argv else "all"
    run_ncu = "--no-ncu" not in argv
    if mode not in ("t12", "box", "bound", "all"):
        raise SystemExit(f"torch_tile_probe: unknown mode {mode!r}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_tile_probe: no CUDA device")
    print(smi(), flush=True)
    out = {"device": torch.cuda.get_device_name(0), "smi": smi()}
    if mode in ("t12", "all"):
        t12(out, run_ncu)
    if mode in ("box", "all"):
        box(out)
    if mode in ("bound", "all"):
        bound(out)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
