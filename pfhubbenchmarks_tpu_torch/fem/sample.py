"""Point evaluation and line sampling of P1 fields on the crossed grid.

Counterpart of ``pfhubbenchmarks_tpu/fem/sample.py``, which replaces the
reference's MPI eval-anywhere machinery (``peval``, dolfin/pfbase.py:50-63,
and ``sample``, :69-94). On a structured grid point evaluation is closed
form: locate the cell, pick the triangle by a region test, interpolate
barycentrically. The evaluation runs on the state's device, in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.fem.grid import CrossedTriGrid


def eval_at_points(grid: CrossedTriGrid, w, xs, ys) -> torch.Tensor:
    """Evaluate all fields at the points (xs, ys): returns [F, *points].

    xs and ys are scalars or arrays of physical coordinates inside
    [0, Lx] x [0, Ly]."""
    v, m = w
    xs = torch.as_tensor(xs, dtype=v.dtype, device=v.device)
    ys = torch.as_tensor(ys, dtype=v.dtype, device=v.device)
    gx = xs / grid.hx
    gy = ys / grid.hy
    ci = torch.clamp(torch.floor(gx).long(), 0, grid.nx - 1)
    cj = torch.clamp(torch.floor(gy).long(), 0, grid.ny - 1)
    xi = gx - ci     # cell-local in [0, 1]
    eta = gy - cj

    u00 = v[:, cj, ci]
    u10 = v[:, cj, ci + 1]
    u11 = v[:, cj + 1, ci + 1]
    u01 = v[:, cj + 1, ci]
    uc = m[:, cj, ci]

    # triangle regions in the unit cell (the diagonals cross at the centre):
    #   S: eta <= xi and eta <= 1-xi      N: eta >= xi and eta >= 1-xi
    #   W: xi <= eta and xi <= 1-eta      E: the rest
    south = u00 + (u10 - u00) * xi + (2.0 * uc - u00 - u10) * eta
    north = u01 + (u11 - u01) * xi + (u01 + u11 - 2.0 * uc) * (eta - 1.0)
    west = u00 + (u01 - u00) * eta + (2.0 * uc - u00 - u01) * xi
    east = u10 + (u11 - u10) * eta + (u10 + u11 - 2.0 * uc) * (xi - 1.0)

    in_s = (eta <= xi) & (eta <= 1.0 - xi)
    in_n = (eta >= xi) & (eta >= 1.0 - xi)
    in_w = (xi <= eta) & (xi <= 1.0 - eta)
    return torch.where(in_s, south,
                       torch.where(in_n, north, torch.where(in_w, west, east)))


def sample_grid(grid: CrossedTriGrid, w, nx_s: int, ny_s: int):
    """Uniform [nx_s, ny_s] resampling of all fields (pfbase.sample parity).

    Returns (xs [nx_s], ys [ny_s], values [F, ny_s, nx_s]), numpy on the
    host."""
    xs = np.linspace(0.0, grid.Lx, nx_s)
    ys = np.linspace(0.0, grid.Ly, ny_s)
    X, Y = np.meshgrid(xs, ys)
    vals = eval_at_points(grid, w, X.ravel(), Y.ravel())
    return xs, ys, vals.cpu().numpy().reshape(-1, ny_s, nx_s)
