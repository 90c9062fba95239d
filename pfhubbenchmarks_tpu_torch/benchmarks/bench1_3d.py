"""PFHub BM1 in 3D: Cahn-Hilliard on a 100^3 box, 50^3 hex cells of 6 Kuhn
tets each.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/bench1_3d.py``. Reference:
dolfin/b13d.py: BoxMesh 50^3 over 100^3 (:24-26), BM1's parameters and IC
(the 2D cosine IC applied z-invariantly), end_time 50, dt0 0.1, dt_min 1e-2
(:118-128). The solver configuration is the JAX package's verbatim, whose
comments record the measurements behind each setting: GMG 50^3 -> 25^3 ->
5^3 rediscretized at keast2, the K-cycle (``gmg_kcycle=3``) on 25^3, the
exact dense inverse on 5^3 (432 dofs), ``fast_residual``, basic line search.
Its committed trajectory is ``results/bench1_3d_out.csv`` (24 rows to
t = 52.7, from the JAX package).

On a CUDA device the outer Krylov J.v (ffc3) and every level's J.v (keast2)
are kernel U (ops/fem_jvp3d.py), the smoothing sweeps kernel L over U's body
(ops/lmr.py).

Run: ``python -m pfhubbenchmarks_tpu_torch.benchmarks.bench1_3d``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import (Bench1Params, ic_c,
                                                         kernel_constants,
                                                         make_terms)
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.assembly3d import (DirichletBC3D,
                                                      make_functional3d,
                                                      make_residual3d)
from pfhubbenchmarks_tpu_torch.fem.grid3d import TetGrid


@dataclasses.dataclass
class Benchmark3DProblem:
    """3D counterpart of ``BenchmarkProblem`` (one vertex grid, states
    ``(v,)``); the factory methods take the device explicitly, as there.
    A benchmark without ``terms_tangent`` and ``kernel_jvp`` (poisson3d)
    runs the f64 Krylov branch (``mixed_precision=False``) with the
    block-Jacobi of ``torch.func.jvp`` of its terms."""

    name: str
    grid: TetGrid
    field_names: tuple
    terms: Callable                       # QPContext -> (source, flux)
    ic_fns: list                          # per-field fn(x, y, z)
    observables: dict
    csv_columns: tuple
    # the hand-written pointwise tangent of terms (kernel U's physics, the
    # multigrid's block-Jacobi blocks), or None
    terms_tangent: Callable | None = None
    # (grid, device, dirichlet=()) -> jv(w, w0, dt, v, b=None), the f32 J.v
    # of terms with the identity rows of the DirichletBC3D faces dirichlet,
    # or None (the f64 branch; mixed precision then raises)
    kernel_jvp: Callable | None = None
    time: TimeConfig = TimeConfig()
    solver: SolverConfig = SolverConfig()
    # (field, face, fn(c1, c2)) specs -> DirichletBC3D (fem/assembly3d.py)
    dirichlet_spec: tuple = ()
    needs_coords: bool = False
    dtype: torch.dtype = torch.float64
    abort_condition: Callable | None = None
    # non-integral observables: name -> fn(state) -> scalar tensor
    custom_observables: dict = dataclasses.field(default_factory=dict)
    # TPU-only (rows per dispatch of the segmented whole-run loop): no-op.
    fused_seg_rows: int | None = None

    @property
    def n_fields(self) -> int:
        return len(self.field_names)

    def dirichlet_for(self, grid: TetGrid) -> tuple[DirichletBC3D, ...]:
        """The faces of ``dirichlet_spec`` on ``grid`` (every multigrid level
        rebuilds its own)."""
        return tuple(DirichletBC3D.make(grid, f, face, fn)
                     for (f, face, fn) in self.dirichlet_spec)

    @property
    def dirichlet(self) -> tuple[DirichletBC3D, ...]:
        return self.dirichlet_for(self.grid)

    def initial_state(self, device: torch.device | str):
        """The IC interpolated at the vertices, with the BC values set."""
        (v,) = self.grid.interpolate(self.ic_fns)
        v = torch.as_tensor(v, dtype=self.dtype, device=device)
        for bc in self.dirichlet:
            v = bc.apply_value(v)
        return (v,)

    def residual(self, device: torch.device | str, dtype=None):
        return make_residual3d(self.grid, self.terms, self.n_fields,
                               device=device, dirichlet=self.dirichlet,
                               needs_coords=self.needs_coords,
                               dtype=dtype or self.dtype)

    @property
    def mixed_precision(self) -> bool:
        return self.solver.mixed_precision and self.dtype == torch.float64

    def residual_lowp(self, device: torch.device | str):
        """f32 true-rule residual: the staged ``fast_residual`` Newton
        residual and the linearization point of the Krylov operator."""
        return (self.residual(device, dtype=torch.float32)
                if self.mixed_precision else None)

    def lowp_jvp_factory(self, device: torch.device | str):
        """``factory(x_lp, wprev_lp, dt_lp) -> jvp(v)``: the outer f32 J.v on
        the true-rule grid (kernel U at ffc3), with the Dirichlet rows. None
        on the f64 branch; mixed precision without ``kernel_jvp`` raises."""
        if not self.mixed_precision:
            return None
        if self.kernel_jvp is None:
            raise NotImplementedError(
                f"{self.name}: mixed precision needs a kernel J.v, which is "
                "not yet ported for it (mixed_precision=False runs the f64 "
                "branch)")
        jv = self.kernel_jvp(self.grid, device, self.dirichlet)

        def factory(x_lp, wprev_lp, dt_lp):
            return lambda v: jv(x_lp, wprev_lp, dt_lp, v)

        return factory

    def precond_builder(self, device: torch.device | str):
        """'gmg': the K-cycle or V-cycle of solve/gmg3d.py (f32 kernels; an
        f64 cycle raises). Every other ``precond`` is the block-Jacobi of
        ``torch.func.jvp`` of the terms in the Krylov dtype, as the JAX
        package builds it for any value but 'gmg' (``bench1_3d.py:162-164``;
        ROADMAP Queue 3)."""
        s = self.solver
        if s.precond != "gmg":
            from pfhubbenchmarks_tpu_torch.solve.precond import (
                make_block_jacobi3d_terms)

            return make_block_jacobi3d_terms(
                self.grid, self.terms, self.n_fields, device=device,
                dirichlet=self.dirichlet,
                dtype=torch.float32 if self.mixed_precision else self.dtype,
                needs_coords=self.needs_coords)
        if not self.mixed_precision:
            raise NotImplementedError(
                f"{self.name}: precond='gmg' with mixed_precision=False (an "
                "f64 cycle) is not yet ported: the cycle kernels are f32")
        from pfhubbenchmarks_tpu_torch.solve.gmg3d import make_gmg3d

        return make_gmg3d(
            self.grid, self.terms, self.n_fields, device=device,
            jvp_for=lambda g: self.kernel_jvp(g, device, self.dirichlet_for(g)),
            tangent=self.terms_tangent, dirichlet_for=self.dirichlet_for,
            nu_pre=s.gmg_nu_pre, nu_post=s.gmg_nu_post,
            nu_fine_pre=s.gmg_nu_fine_pre, nu_fine_post=s.gmg_nu_fine_post,
            coarse_sweeps=s.gmg_coarse_sweeps, max_levels=s.gmg_max_levels,
            precond_rule=s.precond_rule, cycle=s.gmg_cycle,
            inner_mr=s.gmg_inner_mr, kcycle=s.gmg_kcycle,
            dense_coarse_max_dofs=s.gmg_dense_coarse_max_dofs)

    def observable_fns(self, device: torch.device | str):
        out = {name: make_functional3d(self.grid, density, device=device,
                                       needs_coords=self.needs_coords,
                                       dtype=self.dtype)
               for name, density in self.observables.items()}
        out.update(self.custom_observables)
        return out


def make(nx: int = 50, ny: int = 50, nz: int = 50, Lx: float = 100.0,
         Ly: float = 100.0, Lz: float = 100.0,
         params: Bench1Params = Bench1Params(), pad_to: tuple = (1, 1, 1),
         **overrides) -> Benchmark3DProblem:
    p = params
    terms, terms_tangent, _, f_chem = make_terms(p)
    ic = ic_c(p)

    def tfe_density(ctx):
        c = ctx.u[0]
        dc = ctx.du[0]
        return f_chem(c) + p.kappa / 2.0 * (dc[0] ** 2 + dc[1] ** 2 + dc[2] ** 2)

    def kernel_jvp(grid, device, dirichlet=()):
        from pfhubbenchmarks_tpu_torch.ops.fem_jvp3d import make_ch3d_jvp

        return make_ch3d_jvp(grid, terms_tangent, kernel_constants(p),
                             device=device, dirichlet=dirichlet)

    return Benchmark3DProblem(
        name="bench1_3d",
        grid=TetGrid(nx, ny, nz, Lx, Ly, Lz, pad_to=pad_to),
        field_names=("c", "mu"),
        terms=terms,
        terms_tangent=terms_tangent,
        ic_fns=[lambda x, y, z: ic(x, y), lambda x, y, z: 0.0 * x],
        observables={
            "total_free_energy": tfe_density,
            "total_solute": lambda ctx: ctx.u[0],
        },
        csv_columns=("time", "total_free_energy", "total_solute"),
        kernel_jvp=kernel_jvp,
        **{"time": TimeConfig(dt0=1e-1, dt_min=1e-2, end_time=50.0,
                              grow_threshold=5),
           "solver": SolverConfig(line_search="basic", precond="gmg",
                                  precond_rule="keast2", fast_residual=True,
                                  gmg_kcycle=3, tiled_nb1_3d=True),
           **overrides},
    )


if __name__ == "__main__":
    from pfhubbenchmarks_tpu_torch.benchmarks.registry import main

    main("bench1_3d")
