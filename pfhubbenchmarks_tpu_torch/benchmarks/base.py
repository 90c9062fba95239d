"""Benchmark problem container: everything a time loop needs, declaratively.

Counterpart of ``pfhubbenchmarks_tpu/benchmarks/base.py``. A benchmark is
data: a grid, a pointwise ``terms`` function, ICs, Dirichlet specs,
observables and configs. Every factory method takes the device explicitly.
``kernel_jvp(grid, device, dirichlet, split=False, form="gather")`` makes
the benchmark's J.v (kernel A for BM1, E for BM6, F for BM2, G for BM3, each
with the benchmark's hand-written pointwise tangent as its plain version)
with identity rows on the Dirichlet rows, which serves the outer Krylov
matvec (the JAX package re-sets those rows after its kernel,
``base.py:201-215``) and every multigrid level; ``split=True`` gives the
J.v of ``terms_precond``, the field-split operator of
``SolverConfig.field_split``; ``form`` "recompute" or "seam" the tile
kernels T10 or T12 (ops/fem_tile.py) in place of the gather kernel, "box"
kernel W (ops/tri_box.py, BM1, BM2, BM3 and BM6 with its Dirichlet rows),
which ``outer_jvp_form`` gives the outer J.v and the exported A z of bench1,
bench2, bench3 and bench6 (whose Dirichlet rows leave it no exported A z).
``kernel_residual(grid, device, dirichlet, form="gather")`` makes the f32
residual of kernel R (ops/fem_residual.py), where the benchmark has one, or
for ``form`` "box" the residual box (ops/residual_box.py, BM2 and BM6),
which ``residual_form`` gives the cp line search of bench2 and bench6; and
``kernel_phys()`` the physics of the gather kernels S and Q (ops/fem_jvp.py,
BM1 and BM3).

The tiled configuration (``SolverConfig.use_tiled_sweeps`` and
``tiled_grid_kernels``, the JAX package's switch for its tiled kernels past
VMEM) routes the outer J.v of a grid with more than one row block
(ops/fem_tile.multi_block) to T10, and the levels of the multigrid
hierarchy with no Dirichlet rows and more than one row block to T12 and
the tiled sweep loop (solve/gmg.py).

The linear benchmarks (poisson, elast) have no ``kernel_jvp``: they run the
f64 Krylov branch (``SolverConfig.mixed_precision=False``, solve/newton.py),
whose J.v is ``torch.func.jvp`` of the f64 residual, with a ``precond``
other than 'gmg' (``precond_builder``: ``solve/precond.BUILDERS``), as the
JAX package runs them in XLA. ``needs_coords`` gives their forms the
quadrature points' coordinates, ``custom_observables`` their non-integral
observables (elast's tip deflection, fem/sample.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig
from pfhubbenchmarks_tpu_torch.fem.assembly import (DirichletBC, make_functional,
                                                    make_residual)
from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid
from pfhubbenchmarks_tpu_torch.solve.precond import BUILDERS


@dataclasses.dataclass
class BenchmarkProblem:
    name: str
    grid: CrossedTriGrid
    field_names: tuple[str, ...]
    terms: Callable                       # QPContext -> (source, flux)
    ic_fns: Sequence[Callable]            # per-field fn(x, y)
    observables: dict[str, Callable]      # name -> density(QPContext)
    csv_columns: tuple[str, ...]
    # (grid, device, dirichlet, split=False, form="gather") -> jv(w, w0, dt,
    # v, b=None), the f32 J.v of terms (split: of terms_precond; form: the
    # gather kernel or a tile kernel's form); None for the f64 branch's
    # benchmarks, which mixed precision then refuses
    kernel_jvp: Callable | None = None
    # (grid, device, dirichlet, form="gather") -> res(w, w0, dt), the f32
    # residual of kernel R (form "box": the residual box), or None (the
    # plain f32 assembly then serves)
    kernel_residual: Callable | None = None
    # () -> ops/fem_jvp.KernelPhys, the physics of the gather kernels S (the
    # sharded LMR smoother) and Q (the row-block probe), or None where they
    # have no instantiation
    kernel_phys: Callable | None = None
    time: TimeConfig = TimeConfig()
    solver: SolverConfig = SolverConfig()
    # (field, side, fn(coord)) specs, instantiated per grid so multigrid can
    # rebuild the BCs on coarse levels
    dirichlet_spec: tuple = ()
    # Field-split preconditioning (SolverConfig.field_split): a copy of
    # ``terms`` with the cross-group couplings detached, so every
    # preconditioner linearization is block diagonal by ``field_groups``
    # (contiguous field ranges). The outer residual and Krylov operator
    # always use ``terms``.
    terms_precond: Callable | None = None
    field_groups: tuple | None = None
    # the forms read the quadrature points' coordinates (ctx.x, ctx.y)
    needs_coords: bool = False
    dtype: torch.dtype = torch.float64
    # optional scaling applied to an observable value after integration
    # (bench3's solid fraction over the domain area)
    observable_scale: dict[str, float] = dataclasses.field(default_factory=dict)
    # optional early-abort predicate on a CSV row dict (bench3: TFE < 0,
    # dolfin/bench3.py:254-258), read by the host loop (timeloop.run)
    abort_condition: Callable[[dict], bool] | None = None
    # the form of kernel_jvp for the outer f32 J.v (T10 in its place in the
    # tiled configuration) and the exported A z on the true-rule grid:
    # "gather", or "box" (kernel W, ops/tri_box.py; bench1, bench2, bench3
    # and bench6)
    outer_jvp_form: str = "gather"
    # the form of kernel_residual for the f32 residual of the cp line search
    # (residual_lowp): "gather" (kernel R), or "box" (the residual box,
    # ops/residual_box.py; bench2 and bench6)
    residual_form: str = "gather"
    # non-integral observables: name -> fn(state) -> scalar tensor (point
    # samples by fem/sample.py: elast's tip deflection)
    custom_observables: dict[str, Callable] = dataclasses.field(
        default_factory=dict)

    @property
    def n_fields(self) -> int:
        return len(self.field_names)

    def dirichlet_for(self, grid: CrossedTriGrid) -> tuple[DirichletBC, ...]:
        return tuple(DirichletBC.make(grid, f, side, fn)
                     for (f, side, fn) in self.dirichlet_spec)

    @property
    def dirichlet(self) -> tuple[DirichletBC, ...]:
        return self.dirichlet_for(self.grid)

    def initial_state(self, device: torch.device | str):
        v, m = self.grid.interpolate(self.ic_fns)
        v = torch.as_tensor(np.asarray(v), dtype=self.dtype, device=device)
        for bc in self.dirichlet:
            v = bc.apply_value(v)
        return v, torch.as_tensor(np.asarray(m), dtype=self.dtype, device=device)

    def residual(self, device: torch.device | str, dtype=None):
        return make_residual(self.grid, self.terms, self.n_fields, device=device,
                             dirichlet=self.dirichlet,
                             needs_coords=self.needs_coords,
                             dtype=dtype or self.dtype)

    @property
    def mixed_precision(self) -> bool:
        return self.solver.mixed_precision and self.dtype == torch.float64

    def residual_lowp(self, device: torch.device | str):
        """f32 true-rule residual, the one the fast cp line search and its
        noise floor read (solve/newton.py): kernel R or the residual box
        (``residual_form``) where the benchmark has it, else the f32
        assembly."""
        if not self.mixed_precision:
            return None
        if self.kernel_residual is None:
            return self.residual(device, dtype=torch.float32)
        return self.kernel_residual(self.grid, device, self.dirichlet,
                                    form=self.residual_form)

    @property
    def tiled(self) -> bool:
        """The tiled configuration (both of the JAX package's switches)."""
        return self.solver.use_tiled_sweeps and self.solver.tiled_grid_kernels

    def lowp_jvp_factory(self, device: torch.device | str):
        """``factory(x_lp, wprev_lp, dt_lp) -> jvp(v)``: the outer f32 J.v
        on the true-rule grid, whose Dirichlet rows equal ``v``, of the form
        ``outer_jvp_form``; T10 in the tiled configuration on a grid of
        several row blocks. None on the f64 branch (no mixed precision);
        mixed precision without ``kernel_jvp`` raises."""
        from pfhubbenchmarks_tpu_torch.ops.fem_tile import multi_block

        if not self.mixed_precision:
            return None
        if self.kernel_jvp is None:
            raise NotImplementedError(
                f"{self.name}: mixed precision needs a kernel J.v, which is "
                "not yet ported for it (mixed_precision=False runs the f64 "
                "branch)")

        form = ("recompute" if self.tiled and multi_block(self.grid)
                else self.outer_jvp_form)
        jv = self.kernel_jvp(self.grid, device, self.dirichlet, form=form)

        def factory(x_lp, wprev_lp, dt_lp):
            return lambda v: jv(x_lp, wprev_lp, dt_lp, v)

        return factory

    def precond_builder(self, device: torch.device | str):
        """The build of ``solver.precond``, as the JAX package dispatches it
        (``base.py:244-284``): 'gmg' the kernels' V-cycle (f32; with
        ``mixed_precision=False`` it raises: an f64 V-cycle is not yet
        ported), else ``solve/precond.BUILDERS`` in the Krylov dtype."""
        s = self.solver
        if s.precond != "gmg":
            kry_dtype = torch.float32 if self.mixed_precision else self.dtype
            if s.precond == "none":
                return BUILDERS["none"]()
            extra = dict(impl=s.dense_impl) if s.precond == "dense" else {}
            return BUILDERS[s.precond](
                self.grid, self.terms, self.n_fields, device=device,
                dirichlet=self.dirichlet, dtype=kry_dtype,
                needs_coords=self.needs_coords, **extra)
        if not self.mixed_precision:
            raise NotImplementedError(
                f"{self.name}: precond='gmg' with mixed_precision=False (an "
                "f64 V-cycle) is not yet ported: the cycle kernels are f32")
        from pfhubbenchmarks_tpu_torch.solve.gmg import make_gmg

        # field split: the hierarchy linearizes terms_precond (block
        # diagonal); the exported A z stays the coupled terms
        field_split = s.field_split and self.terms_precond is not None
        return make_gmg(
            self.grid, self.terms_precond if field_split else self.terms,
            self.n_fields, device=device,
            jvp_for=lambda g, split, form="gather": self.kernel_jvp(
                g, device, self.dirichlet_for(g), split=split, form=form),
            mv_form=self.outer_jvp_form, fuse_vcycle=s.fuse_vcycle,
            tiled=self.tiled,
            field_groups=self.field_groups if field_split else None,
            dirichlet_for=self.dirichlet_for,
            nu_pre=s.gmg_nu_pre, nu_post=s.gmg_nu_post,
            nu_fine_pre=s.gmg_nu_fine_pre, nu_fine_post=s.gmg_nu_fine_post,
            coarse_sweeps=s.gmg_coarse_sweeps, max_levels=s.gmg_max_levels,
            precond_rule=s.precond_rule, min_cells=s.gmg_min_cells,
            dense_coarse_max_dofs=s.gmg_dense_coarse_max_dofs,
            cycle=s.gmg_cycle, inner_mr=s.gmg_inner_mr)

    def observable_fns(self, device: torch.device | str):
        out = {}
        for name, density in self.observables.items():
            fn = make_functional(self.grid, density, device=device,
                                 needs_coords=self.needs_coords,
                                 dtype=self.dtype)
            scale = self.observable_scale.get(name)
            if scale is not None:
                fn = (lambda f, sc: (lambda w: f(w) * sc))(fn, scale)
            out[name] = fn
        out.update(self.custom_observables)
        return out
