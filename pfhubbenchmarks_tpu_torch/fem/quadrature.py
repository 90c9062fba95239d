"""Quadrature rules on the UFC reference triangle ((0,0), (1,0), (0,1)) and
tetrahedron ((0,0,0), (1,0,0), (0,1,0), (0,0,1)).

The reference runs FFC with ``quadrature_degree = 3`` (dolfin/bench1.py:16),
which resolves to a FIAT *collapsed* Gauss-Jacobi (Duffy) rule with
``(degree + 2) // 2`` points per axis. Several benchmark integrands exceed
degree 3 (e.g. bench1's quartic f_chem), so the committed reference CSVs carry
that rule's quadrature signature; ``ffc_triangle(3)`` reproduces it so the
port can match the reference numbers, while ``dunavant(d)`` provides
symmetric exact rules for convergence/validation work.

All construction is host-side numpy float64; results are baked into element
tabulations at setup (fem/grid.py) and become compile-time constants.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TriRule:
    """Points/weights on the UFC triangle; weights sum to the area 1/2."""

    points: np.ndarray   # [nq, 2]
    weights: np.ndarray  # [nq]
    name: str = ""

    @property
    def n(self) -> int:
        return self.points.shape[0]


def gauss_legendre(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1]."""
    return np.polynomial.legendre.leggauss(n)


def gauss_jacobi(n: int, alpha: float, beta: float) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Jacobi nodes/weights on [-1, 1] for weight (1-x)^a (1+x)^b.

    Golub-Welsch on the symmetric Jacobi recurrence matrix.
    """
    a, b = float(alpha), float(beta)
    k = np.arange(n, dtype=np.float64)
    s = 2.0 * k + a + b
    # Diagonal (recurrence alpha_k); k=0 handled separately for a+b ~ 0.
    with np.errstate(invalid="ignore", divide="ignore"):
        diag = (b * b - a * a) / (s * (s + 2.0))
    if a + b == 0.0 or a + b == -1.0:
        diag[0] = (b - a) / (a + b + 2.0)
    # Off-diagonal (sqrt of beta_k), k = 1..n-1
    kk = np.arange(1, n, dtype=np.float64)
    sk = 2.0 * kk + a + b
    beta_k = (4.0 * kk * (kk + a) * (kk + b) * (kk + a + b)
              / (sk * sk * (sk + 1.0) * (sk - 1.0)))
    off = np.sqrt(beta_k)
    T = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    vals, vecs = np.linalg.eigh(T)
    mu0 = 2.0 ** (a + b + 1.0) * math.gamma(a + 1.0) * math.gamma(b + 1.0) / math.gamma(a + b + 2.0)
    w = mu0 * vecs[0, :] ** 2
    return vals, w


def fiat_collapsed_triangle(m: int) -> TriRule:
    """FIAT-style collapsed (Duffy) rule: m x m points, exact to degree 2m-1.

    Construction mirrors FIAT's CollapsedQuadratureTriangleRule: a
    Gauss-Legendre rule on the xi axis and a Gauss-Jacobi(1, 0) rule on the
    eta (collapsed) axis, mapped square -> triangle via
    xi1 = (1 + xi)(1 - eta)/2 - 1 on the [-1,1] triangle, then to UFC coords.
    This is the rule FFC generates for simplex cells.
    """
    gx, wx = gauss_legendre(m)
    gy, wy = gauss_jacobi(m, 1.0, 0.0)
    pts = []
    wts = []
    for j in range(m):          # eta (collapsed axis) outer — FIAT ordering
        for i in range(m):
            xi1 = 0.5 * (1.0 + gx[i]) * (1.0 - gy[j]) - 1.0
            xi2 = gy[j]
            x = 0.5 * (xi1 + 1.0)
            y = 0.5 * (xi2 + 1.0)
            pts.append((x, y))
            wts.append(wx[i] * wy[j])
    w = np.asarray(wts)
    w *= 0.5 / w.sum()          # normalize to triangle area 1/2
    return TriRule(np.asarray(pts), w, name=f"fiat_collapsed_{m}")


def ffc_triangle(degree: int) -> TriRule:
    """The rule FFC uses for ``quadrature_degree=degree`` on triangles."""
    return fiat_collapsed_triangle((degree + 2) // 2)


_DUNAVANT: dict[int, tuple[list[tuple[float, float, float]], list[float]]] = {
    # degree: ([(barycentric a, b, c) orbit representatives], [weights per point])
    1: ([(1 / 3, 1 / 3, 1 / 3)], [1.0]),
    2: ([(2 / 3, 1 / 6, 1 / 6)], [1 / 3]),
    3: ([(1 / 3, 1 / 3, 1 / 3), (0.6, 0.2, 0.2)], [-0.5625, 0.520833333333333]),
    4: (
        [
            (0.108103018168070, 0.445948490915965, 0.445948490915965),
            (0.816847572980459, 0.091576213509771, 0.091576213509771),
        ],
        [0.223381589678011, 0.109951743655322],
    ),
    5: (
        [
            (1 / 3, 1 / 3, 1 / 3),
            (0.059715871789770, 0.470142064105115, 0.470142064105115),
            (0.797426985353087, 0.101286507323456, 0.101286507323456),
        ],
        [0.225, 0.132394152788506, 0.125939180544827],
    ),
}


def dunavant(degree: int) -> TriRule:
    """Symmetric Dunavant rule exact to ``degree`` (1..5)."""
    if degree not in _DUNAVANT:
        raise ValueError(f"no Dunavant table for degree {degree}")
    orbits, wts = _DUNAVANT[degree]
    pts = []
    w = []
    for (a, b, c), wt in zip(orbits, wts):
        perms = {(a, b, c), (b, c, a), (c, a, b), (a, c, b), (c, b, a), (b, a, c)}
        for l1, l2, l3 in sorted(perms):
            # UFC triangle: x = l2, y = l3 with vertices (0,0),(1,0),(0,1)
            pts.append((l2, l3))
            w.append(wt)
    w = np.asarray(w) * 0.5 / np.sum(w)
    return TriRule(np.asarray(pts), w, name=f"dunavant_{degree}")


@dataclasses.dataclass(frozen=True)
class TetRule:
    """Points/weights on the UFC tetrahedron; weights sum to volume 1/6."""

    points: np.ndarray   # [nq, 3]
    weights: np.ndarray  # [nq]
    name: str = ""

    @property
    def n(self) -> int:
        return self.points.shape[0]


def fiat_collapsed_tet(m: int) -> TetRule:
    """FIAT-style collapsed (Duffy) rule on the UFC tetrahedron:
    GL x GJ(1,0) x GJ(2,0), m^3 points, exact to degree 2m-1."""
    gx, wx = gauss_legendre(m)
    gy, wy = gauss_jacobi(m, 1.0, 0.0)
    gz, wz = gauss_jacobi(m, 2.0, 0.0)
    pts = []
    wts = []
    for k in range(m):
        for j in range(m):
            for i in range(m):
                x, y, z = gx[i], gy[j], gz[k]
                xi1 = 0.25 * (1.0 + x) * (1.0 - y) * (1.0 - z) - 1.0
                xi2 = 0.5 * (1.0 + y) * (1.0 - z) - 1.0
                xi3 = z
                pts.append(((xi1 + 1) / 2, (xi2 + 1) / 2, (xi3 + 1) / 2))
                wts.append(wx[i] * wy[j] * wz[k])
    w = np.asarray(wts)
    w *= (1.0 / 6.0) / w.sum()
    return TetRule(np.asarray(pts), w, name=f"fiat_tet_{m}")


def ffc_tet(degree: int) -> TetRule:
    """The rule FFC uses for ``quadrature_degree=degree`` on tetrahedra."""
    return fiat_collapsed_tet((degree + 2) // 2)


def tet_monomial_integral(a: int, b: int, c: int) -> float:
    """Exact integral of x^a y^b z^c over the UFC tetrahedron."""
    return (math.factorial(a) * math.factorial(b) * math.factorial(c)
            / math.factorial(a + b + c + 3))


def keast_tet(degree: int) -> TetRule:
    """Keast symmetric tet rules: degree 1 (1 point, the centroid) and
    degree 2 (4 points), the cheap rules of a preconditioner's
    rediscretization (SolverConfig.precond_rule)."""
    if degree <= 1:
        return TetRule(np.array([[0.25, 0.25, 0.25]]),
                       np.array([1.0 / 6.0]), name="keast_1")
    if degree == 2:
        a, b = 0.5854101966249685, 0.1381966011250105
        pts = np.array([[a, b, b], [b, a, b], [b, b, a], [b, b, b]])
        w = np.full(4, 1.0 / 24.0)
        return TetRule(pts, w, name="keast_2")
    raise ValueError(f"keast rule degree {degree} not tabulated")


def get_tet_rule(name: str) -> TetRule:
    """Resolve a tet rule by name: 'ffcN', 'fiatN', 'keastN'."""
    if name.startswith("ffc"):
        return ffc_tet(int(name[3:]))
    if name.startswith("fiat"):
        return fiat_collapsed_tet(int(name[4:]))
    if name.startswith("keast"):
        return keast_tet(int(name[5:]))
    raise ValueError(f"unknown tet quadrature rule {name!r}")


def get_rule(name: str) -> TriRule:
    """Resolve a rule by name: 'ffc3' (reference parity), 'dunavantN', 'fiatN'."""
    if name.startswith("ffc"):
        return ffc_triangle(int(name[3:]))
    if name.startswith("dunavant"):
        return dunavant(int(name[8:]))
    if name.startswith("fiat"):
        return fiat_collapsed_triangle(int(name[4:]))
    raise ValueError(f"unknown quadrature rule {name!r}")

