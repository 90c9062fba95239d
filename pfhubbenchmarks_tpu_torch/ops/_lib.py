"""Build, load and count the hand-written CUDA kernels.

The sources in ``pfhubbenchmarks_tpu_torch/csrc/*.cu`` are compiled by
``nvcc``, one process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into
``pfhubbenchmarks_tpu_torch/_build/`` (ignored by git), and loaded with
``ctypes``. The library name carries a hash of the sources and flags,
so an edited source is rebuilt. Nothing here runs at import time: the CPU
tests import every module, and a CPU tensor never reaches a kernel.

Each wrapper counts its launches in ``LAUNCHES`` (one per wrapper call that
launches its kernel), so a run can show that its main path went through the
kernels. The tiled LMR sweep loop (ops/lmr.py) and the launch sequences of
the two V-cycle level steps and the two chains (ops/vcycle_chain.py
``.sequence``) are not kernels: they count their calls in ``CALLS``. The
gather sweep loop is one kernel, L (``lmr_sweep``; ``lmr_loop_chp3d`` at
bench6_3d's physics), each chain of gather
levels one launch of ``vcycle_descend_chain`` or ``vcycle_ascend_chain``, and
a whole V-cycle apply with its exported A z one of ``vcycle_fused`` (V).
``SECONDS`` holds the host seconds of the multigrid build and its stages,
so a run can say what share of its wall they take, and ``ENTRIES`` how many
times each ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

KERNELS = ("ch_jvp", "chp_jvp", "chac_jvp", "ach_jvp", "ch3d_jvp",
           "ch3d_tile", "block_jacobi_apply", "lmr_step", "lmr_sweep", "transfer_dyadic",
           "transfer_general", "residual", "tile_jvp_recompute",
           "tile_jvp_seam", "tile_sweep", "fma_chain", "shard_sweep",
           "gridjvp_probe", "vcycle_descend_chain", "vcycle_ascend_chain",
           "node_blocks", "tri_box", "residual_box", "vcycle_fused",
           # N's one-launch build of a hierarchy; W at BM6's physics with its
           # Dirichlet rows (bench6's outer J.v, counted apart from W)
           "node_build", "tri_box_chp",
           # the anisotropic BM3's instantiations, counted apart
           "acha_jvp", "tri_box_acha", "vcycle_descend_chain_acha",
           "vcycle_ascend_chain_acha",
           # U and L at bench6_3d's physics with the Dirichlet mask
           "chp3d_tile", "lmr_loop_chp3d")
LAUNCHES = dict.fromkeys(KERNELS, 0)
# the physics whose launches are counted under their own names,
# ``<kernel>_<kind>`` (the anisotropic BM3's W and chains), and the
# (kernel, physics) pairs counted so (W at BM6's physics, bench6's outer J.v)
COUNTED_APART = ("acha", ("tri_box", "chp"))
# (kernel, physics) pairs counted under a name of their own: L at bench6_3d's
# physics
COUNTED_AS = {("lmr_sweep", "chp3d"): "lmr_loop_chp3d"}
# launch sequences of the kernels that stand for one TPU kernel each
CHAINS = ("tile_sweep_loop", "descend_level", "ascend_level",
          "descend_chain", "ascend_chain")
CALLS = dict.fromkeys(CHAINS, 0)


# host seconds of stages: the whole multigrid build (kernel N's planes, the
# injections and the dense coarse inverse) and the dense coarse inverse
# within it (``jacfwd`` and ``torch.linalg.inv``, plain torch, bench3); the
# ``torch.func.jvp`` block build, which only the f64 linear branch's
# block-Jacobi runs on a main path (poisson, poisson3d); and the three parts
# of the dense preconditioner's build (elast, solve/precond.py): the J
# columns, the LU and the explicit inverse
SECONDS = {"precond_build": 0.0, "dense_coarse": 0.0, "jvp_blocks": 0.0,
           "dense_jacobian": 0.0, "dense_lu": 0.0, "dense_inverse": 0.0}
# the times each stage ran (a run's multigrid builds: ``precond_build``)
ENTRIES = dict.fromkeys(SECONDS, 0)


def reset_launches() -> None:
    """Set every kernel's launch count, every chain's call count and every
    stage's seconds and entries to 0."""
    for counts in (LAUNCHES, CALLS, SECONDS, ENTRIES):
        for k in counts:
            counts[k] = type(counts[k])(0)


def counter(name: str, kind: str) -> str:
    """The launch counter of kernel ``name`` at the physics ``kind``."""
    if (name, kind) in COUNTED_AS:
        return COUNTED_AS[(name, kind)]
    apart = kind in COUNTED_APART or (name, kind) in COUNTED_APART
    return f"{name}_{kind}" if apart else name


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def count_call(name: str) -> None:
    CALLS[name] += 1


@contextlib.contextmanager
def timed(name: str, probe: torch.Tensor):
    """Adds the seconds of the block to ``SECONDS[name]`` and one to
    ``ENTRIES[name]``. For a CUDA
    ``probe`` the card is synchronized at both ends, so the block's queued
    device work counts and earlier work does not."""
    on_card = not on_cpu(probe)
    if on_card:
        torch.cuda.synchronize(probe.device)
    t0 = time.perf_counter()
    yield
    if on_card:
        torch.cuda.synchronize(probe.device)
    SECONDS[name] += time.perf_counter() - t0
    ENTRIES[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """The loaded shared library, with its build time and compiler log."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        ip = ctypes.POINTER(ctypes.c_int)
        # kernel L: the operands, then partials, nb, groups, n_sweeps, the
        # grid's cells, one_cta, the grid out, the stream
        loop2 = [vp] * 13 + [vp, i32, i32, vp, i32, i32, i32, i32, ip, vp]
        loop3 = [vp, i32] + [vp] * 6 + [vp, i32, i32, vp, i32, i32, i32, i32,
                                        vp, i32, ip, vp]
        # the chain kernels: ascend, nq, the table, K, the CTAs needed, the
        # call's six pointers, the grid out, the stream
        chain = [i32, i32, vp, i32, i64] + [vp] * 6 + [ip, vp]
        # kernel V: the two point counts, the table, K, the CTAs needed,
        # the cluster, the first level on it, the phases, the call's six
        # pointers, the grid out, the stream
        fused = [i32, i32, vp, i32, i64, i32, i32, i32] + [vp] * 6 + [ip, vp]
        # kernel N: params, the state pair, the diagonals, the mask, the
        # planes out, the node counts, the stream
        nodeb = [vp] * 7 + [i64, i64, vp]
        # N's one-launch build: params, the table, its levels and nodes,
        # the two state pairs, the diagonals, masks and composed index, the
        # planes and states out, the stream
        nbuild = [vp, vp, i32, i64] + [vp] * 10
        sig = {
            "pfh_ch_jvp": [vp, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_chp_jvp": [vp, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_chac_jvp": [vp, i32, i32, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_ach_jvp": [vp, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_acha_jvp": [vp, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_jvp_param_floats": [],
            "pfh_ch3d_jvp": [vp, i32] + [vp] * 4 + [i32] * 3 + [vp],
            # kernel U: params, nq, w, v, b, the Dirichlet mask, out, the
            # grid's cells, the stream
            "pfh_ch3d_tile": [vp, i32] + [vp] * 5 + [i32] * 3 + [vp],
            "pfh_chp3d_tile": [vp, i32] + [vp] * 5 + [i32] * 3 + [vp],
            "pfh_chp3d_tile_info": [i32, ip],
            "pfh_lmr_loop_chp3d_info": [i32, ip],
            "pfh_jvp3_param_floats": [],
            "pfh_ch3d_tile_info": [i32, ip],
            "pfh_ch3d_jvp_info": [i32, ip],
            "pfh_lmr_loop_ch3d_info": [i32, ip],
            "pfh_ach_jvp_info": [i32, ip],
            "pfh_acha_jvp_info": [i32, ip],
            "pfh_ach_tile_info": [i32, i32, ip],
            "pfh_block_jacobi_apply": [vp] * 6 + [i32, i64, i64, i32, vp, vp],
            "pfh_lmr_step": [vp] * 8 + [i64, i64, i32, i32, vp, vp, i32, vp,
                                        vp],
            "pfh_lmr_partials": [vp] * 4 + [i64, i64, i32, i32, vp, vp, i32,
                                            vp],
            "pfh_lmr_update": [vp, i32] + [vp] * 8 + [i64, i64, i32, i32, vp,
                                                      vp, vp],
            "pfh_lmr_loop_ch": [vp, i32] + loop2,
            "pfh_lmr_loop_chp": [vp, i32] + loop2,
            "pfh_lmr_loop_ach": [vp, i32] + loop2,
            "pfh_lmr_loop_acha": [vp, i32] + loop2,
            "pfh_lmr_loop_chac": [vp, i32, i32, i32] + loop2,
            # kernel L in 3D: the operands, partials, nb, groups, n_sweeps,
            # the grid's cells, the Dirichlet mask, one_cta, the grid out,
            # the stream
            "pfh_lmr_loop_ch3d": loop3,
            "pfh_lmr_loop_chp3d": loop3,
            "pfh_shard_sweep_ch": [vp, i32] + [vp] * 11 + [i32, i32, vp],
            "pfh_shard_sweep_ach": [vp, i32] + [vp] * 11 + [i32, i32, vp],
            "pfh_gridjvp_probe": [i32, vp, i32] + [vp] * 6 + [i32] * 3 + [vp],
            "pfh_gridjvp_fold": [vp, vp] + [i32] * 4 + [vp],
            "pfh_transfer": [i32] + [vp] * 5 + [i32] * 4 + [vp],
            "pfh_transfer_general": [i32, i32] + [vp] * 5 + [i32] * 4 + [vp],
            "pfh_transfer_general_upload": [i32, vp],
            "pfh_transfer_general_param_floats": [],
            "pfh_ch_residual": [vp, i32] + [vp] * 8 + [i32, i32, vp],
            "pfh_chp_residual": [vp, i32] + [vp] * 8 + [i32, i32, vp],
            "pfh_chac_residual": [vp, i32, i32] + [vp] * 8 + [i32, i32, vp],
            "pfh_ch_tile": [i32, vp, i32] + [vp] * 14 + [i32, vp, i32, i32,
                                                        vp],
            "pfh_ach_tile": [i32, vp, i32] + [vp] * 14 + [i32, vp, i32, i32,
                                                         vp],
            "pfh_chac_tile": [i32, vp, i32, i32, i32] + [vp] * 14 + [
                i32, vp, i32, i32, vp],
            "pfh_tile_seam_floats": [i32, i32, i32],
            "pfh_fma_chain": [vp, vp, vp, i64, i32, vp],
            "pfh_vcycle_chain_level_bytes": [],
            "pfh_vcycle_chain_pack": [vp] * 6,
            "pfh_vcycle_chain_ch": chain,
            "pfh_vcycle_chain_chp": chain,
            "pfh_vcycle_chain_ach": chain,
            "pfh_vcycle_chain_acha": chain,
            "pfh_vcycle_chain_chac": chain[:2] + [i32, i32] + chain[2:],
            "pfh_vcycle_chain_ch_info": [i32, i32, ip],
            "pfh_vcycle_chain_chp_info": [i32, i32, ip],
            "pfh_vcycle_chain_ach_info": [i32, i32, ip],
            "pfh_vcycle_chain_acha_info": [i32, i32, ip],
            "pfh_vcycle_chain_chac_info": [i32, i32, i32, i32, ip],
            "pfh_vcycle_fused_ch": fused,
            "pfh_vcycle_fused_chac": fused[:2] + [i32] + fused[2:],
            "pfh_vcycle_fused_ch_info": [i32, ip],
            "pfh_vcycle_fused_chac_info": [i32, i32, ip],
            "pfh_node_blocks_ch": nodeb,
            "pfh_node_blocks_chp": nodeb,
            "pfh_node_blocks_ach": nodeb,
            "pfh_node_blocks_chac": nodeb[:1] + [i32, i32] + nodeb[1:],
            "pfh_node_blocks_ch_info": [ip],
            "pfh_node_blocks_chp_info": [ip],
            "pfh_node_blocks_ach_info": [ip],
            "pfh_node_blocks_chac_info": [i32, i32, ip],
            "pfh_node_build_ch": nbuild,
            "pfh_node_build_chp": nbuild,
            "pfh_node_build_ach": nbuild,
            "pfh_node_build_chac": nbuild[:1] + [i32, i32] + nbuild[1:],
            "pfh_node_build_ch_info": [ip],
            "pfh_node_build_chp_info": [ip],
            "pfh_node_build_ach_info": [ip],
            "pfh_node_build_chac_info": [i32, i32, ip],
            # kernel W: params, nq (, ne), the box, the eight planes and
            # the Dirichlet vertex mask (null but at BM6's physics), the
            # grid's cells, the stream
            "pfh_chac_box": [vp, i32, i32, i32, i32] + [vp] * 9 + [i32, i32,
                                                                vp],
            "pfh_ach_box": [vp, i32, i32, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_acha_box": [vp, i32, i32, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_ch_box": [vp, i32, i32, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_chp_box": [vp, i32, i32, i32] + [vp] * 9 + [i32, i32, vp],
            "pfh_chp_box_info": [ip],
            "pfh_chac_box_info": [i32, ip],
            "pfh_ach_box_info": [ip],
            "pfh_acha_box_info": [ip],
            "pfh_ch_box_info": [ip],
            # the residual box: params, nq (, ne), the box, the eight planes
            # (w, w0, mask, g, out), the grid's cells, the stream
            "pfh_chac_rbox": [vp, i32, i32, i32, i32] + [vp] * 8 + [i32, i32,
                                                                 vp],
            "pfh_chp_rbox": [vp, i32, i32, i32] + [vp] * 8 + [i32, i32, vp],
            "pfh_chac_rbox_info": [i32, ip],
            "pfh_chp_rbox_info": [ip],
        }
        for name, argtypes in sig.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch through a C launcher; raise on a nonzero CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")

    def kernel_info(self, name: str, *args) -> dict:
        """What a ``pfh_*_info`` export reports of one kernel instantiation
        (csrc/common.cuh kernel_info): registers and local (spill) bytes
        per thread, static and dynamic shared bytes and co-resident CTAs per
        SM."""
        out = (ctypes.c_int * 5)()
        self.call(name, *args, out)
        return dict(zip(("registers", "local_bytes", "static_smem",
                         "dynamic_smem", "ctas_per_sm"), out))


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


@functools.cache
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libpfhub_kernels-{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        nvcc = _nvcc()
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in srcs]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objs)]
        failed = []
        for src, proc in zip(srcs, procs):
            text = proc.communicate()[0]
            log += f"== {src.name}\n{text}"
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
        for obj in objs:
            obj.unlink()
    return KernelLibrary(out, time.perf_counter() - t0, log)


@functools.cache
def _raw_stream():
    """PyTorch's getters of the current device and of a device's current
    stream as a raw handle (what ``torch.cuda.current_stream().cuda_stream``
    reads, without building a ``Stream`` object); resolved at the first CUDA
    launch, since a CPU build of torch lacks them."""
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


def stream_handle() -> int:
    """The current CUDA stream of the current device, as the launchers take
    it."""
    device, stream = _raw_stream()
    return stream(device())


def check_cuda(name: str, tensors, dtype=torch.float32) -> None:
    """The kernels take contiguous tensors of one dtype on one CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous tensor")


def check_shapes(name: str, pair, vshape, mshape) -> None:
    if tuple(pair[0].shape) != tuple(vshape) or tuple(pair[1].shape) != tuple(mshape):
        raise ValueError(f"{name}: shapes {tuple(pair[0].shape)}, "
                         f"{tuple(pair[1].shape)}; expected {vshape}, {mshape}")


def device_ms(fn, n: int = 40, sleep_cycles: int = 100_000_000) -> float:
    """Device milliseconds of one call of ``fn``: ``n`` calls queued behind
    a sleep kernel (~50 ms), so the card runs their launches back to back,
    between two CUDA events, whatever the host's launch path costs; over
    ``n``."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def on_cpu(t: torch.Tensor) -> bool:
    """Route to the plain version only for a CPU tensor; any other device
    goes to the kernel, which raises if it is not CUDA."""
    return t.device.type == "cpu"
