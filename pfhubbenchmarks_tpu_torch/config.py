"""Global configuration: precision policy and solver defaults.

Field-for-field counterpart of ``pfhubbenchmarks_tpu/config.py``: the
benchmark declarations port verbatim, and a test holds the field names and
defaults equal. The PyTorch slice implements a subset of the knobs; a knob
the slice cannot honour is accepted at its default and raises in
``check_supported`` when set to anything else. The notes beside each field
say which.

Precision policy: f64 Newton residuals and observables, f32 Krylov and
multigrid (f64 Krylov on the linear benchmarks, ``mixed_precision=False``),
and TF32 off everywhere. The TF32 switches below are set once,
when this module is imported: a TF32 matmul keeps ~3 decimal digits, the
Hopper form of the reduced-precision matmul hazard the JAX package fixes
with ``jax_default_matmul_precision='highest'``.
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def tf32_disabled() -> bool:
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Newton-Krylov settings (see the JAX package's config for the
    measurements behind each default)."""

    newton_atol: float = 1e-6
    report_atol: float | None = None
    newton_rtol: float = 1e-8
    newton_stol: float = 1e-8
    newton_max_iters: int = 10
    newton_div_tol: float = 1e4
    newton_stall_abort: int = 0
    # 'basic' and 'cp'; 'bt' is not yet ported.
    line_search: str = "basic"
    # 'fgmres' only; 'gmres', 'bicgstab' and 'richardson' are not yet ported.
    krylov: str = "fgmres"
    krylov_rtol: float = 1e-5
    krylov_atol: float = 1e-50
    krylov_atol_frac: float = 0.01
    krylov_forcing: str = "fixed"   # 'fixed' | 'ew'
    ew_eta0: float = 0.3
    ew_eta_max: float = 0.9
    ew_gamma: float = 0.9
    ew_dt_min: float | None = None
    krylov_max_iters: int = 400
    gmres_restart: int = 30
    # LGMRES augmentation: not yet ported (0 only).
    fgmres_aug: int = 0
    # True: f32 Krylov on the benchmark's kernel J.v. False: the f64 Krylov
    # branch (solve/newton.py: J.v by torch.func.jvp of the f64 residual,
    # f64 FGMRES; poisson, poisson3d, elast), with any precond but 'gmg',
    # whose cycle kernels are f32 (an f64 V-cycle is not yet ported).
    mixed_precision: bool = True
    # Two-stage f32/f64 Newton residual (solve/newton.py).
    fast_residual: bool = False
    fast_residual_margin: float = 1000.0
    # Read by the cp line search: its residual is the f32 one while ||F||
    # stays above fast_residual_margin x the f32 noise floor (solve/newton.py).
    fast_linesearch: bool = True
    # TPU-only (Pallas kernel selection): no-op. On a CUDA device the port
    # always launches its own kernels.
    use_pallas: str = "auto"
    # With tiled_grid_kernels, the tiled configuration: the JAX package
    # takes its tiled kernels on the grids past VMEM; the card has no VMEM,
    # so the port takes them on every grid of more than one row block
    # (ops/fem_tile.multi_block: the JAX package's bc_rows < ny): the outer
    # J.v goes to the tile kernel T10 (the recompute form of
    # pallas_tiled.make_tiled_jvp), and each multigrid level without
    # Dirichlet rows to T12 and the tiled sweep loop of TS (the grid forms
    # of pallas_tiled_grid.py). Ported for bench1, bench2 and bench3;
    # bench6 raises. Alone (tiled_grid_kernels off) it changes nothing: the
    # JAX package's unrolled-launch tiled kernels are the same arithmetic
    # as the port's gather kernels.
    use_tiled_sweeps: bool = True
    # The tiled configuration above, when use_tiled_sweeps is on too. Off:
    # the gather kernels everywhere.
    tiled_grid_kernels: bool = False
    # TPU-only (z-slab Pallas kernels on the 3D level whose slab is the whole
    # grid): no-op. On a CUDA device kernel U covers every level in one launch.
    tiled_nb1_3d: bool = False
    # How the V-cycle is split into launches; every value computes the same
    # cycle. 'auto' (bench1, bench2): on the card, where the JAX package's
    # fused-kernel gate holds (solve/gmg.py fused_gate), the apply with its
    # exported A z is one launch of kernel V (ops/vcycle_fused.py) and the
    # coarsest level is the sweeps; elsewhere, and for 'off', 'split_chain'
    # (bench6) and 'split_levels' (bench3), the descend and ascend chains
    # (ops/vcycle_chain.py) around the coarsest solve.
    fuse_vcycle: str = "auto"
    # 'gmg' (the kernels' V-cycle); 'block_jacobi' (pointwise blocks by
    # torch.func.jvp of the terms), 'dense' (the whole Jacobian's LU inverse,
    # 2D) and 'none' (solve/precond.py). In 3D every value but 'gmg' is
    # block-Jacobi, as in the JAX package (benchmarks/bench1_3d.py).
    precond: str = "gmg"
    # Field-split preconditioning: the V-cycle linearizes the problem's
    # terms_precond (block diagonal by its field_groups); the exported A z
    # stays the coupled operator (solve/gmg.py).
    field_split: bool = False
    # True only (one LMR step length per field group under field_split); a
    # single global step length with field groups is not yet ported.
    field_split_alphas: bool = True
    # 'newton' (a build per Newton iteration) and 'solve' (one build per
    # solve, at the initial guess).
    precond_lag: str = "newton"
    # Read by precond='dense': 'auto' and 'lapack' are its LU form in the
    # working dtype; 'mxu' (the TPU's mxu_inverse) is not yet ported, and
    # dense_refine_iters, its refinement passes, is a no-op.
    dense_impl: str = "auto"
    dense_refine_iters: int = 3
    precond_rule: str | None = None
    # 'true' only; the 'precond_rule' defect-correction operator is not yet
    # ported.
    krylov_operator: str = "true"
    gmg_nu_pre: int = 2
    gmg_nu_post: int = 2
    gmg_nu_fine_pre: int = 0
    gmg_nu_fine_post: int = 0
    # 'v' only; the W-cycle is not yet ported.
    gmg_cycle: str = "v"
    # 1 only; GCR(s) inner acceleration is not yet ported.
    gmg_inner_mr: int = 1
    # 3D multigrid only (solve/gmg3d.py, the K-cycle): no-op in 2D.
    gmg_kcycle: int = 1
    # Unused by the JAX package too (step lengths are computed): no-op.
    gmg_omega: float = 0.8
    gmg_coarse_sweeps: int = 24
    gmg_max_levels: int = 10
    gmg_dense_coarse_max_dofs: int = 1500
    gmg_min_cells: int = 7


# knob -> the values the port honours
_SLICE_ONLY = {
    "line_search": ("basic", "cp"),
    "krylov": "fgmres",
    "fgmres_aug": 0,
    "mixed_precision": (True, False),
    "precond": ("gmg", "block_jacobi", "dense", "none"),
    "dense_impl": ("auto", "lapack"),
    "precond_lag": ("newton", "solve"),
    "krylov_operator": "true",
    "gmg_cycle": "v",
    "gmg_inner_mr": 1,
    "field_split_alphas": True,
}


def check_supported(cfg: SolverConfig) -> None:
    """Raise for a knob set to a value the PyTorch slice cannot honour."""
    for name, ok in _SLICE_ONLY.items():
        ok = ok if isinstance(ok, tuple) else (ok,)
        value = getattr(cfg, name)
        if value not in ok:
            raise NotImplementedError(
                f"SolverConfig.{name}={value!r} is not yet ported to the "
                f"PyTorch package (only {' or '.join(map(repr, ok))})")
    if cfg.precond == "gmg" and not cfg.mixed_precision:
        raise NotImplementedError(
            "SolverConfig(precond='gmg', mixed_precision=False), an f64 "
            "V-cycle, is not yet ported to the PyTorch package: its cycle "
            "kernels are f32")


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    """Adaptive implicit-Euler time-loop settings (dolfin/bench1.py:136-183)."""

    t0: float = 0.0
    dt0: float = 1e-1
    dt_min: float = 1e-2
    dt_max: float | None = None
    end_time: float = 1e3
    grow_threshold: int = 5
    shrink_threshold: int | None = None


def setup_compile_cache(directory: str | None = None) -> None:
    """TPU-only (JAX's persistent compilation cache): no-op. The CUDA
    kernels are built once per checkout into ``pfhubbenchmarks_tpu_torch/
    _build`` (ops/_lib.py)."""
    del directory
