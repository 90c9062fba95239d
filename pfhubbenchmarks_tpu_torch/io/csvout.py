"""Benchmark CSV output matching the reference's np.savetxt contract.

Counterpart of ``pfhubbenchmarks_tpu/io/csvout.py``. Reference:
dolfin/bench1.py:210-219 — comma-delimited, '%1.10f' format, plain header
line, one row [t, observable...] per accepted step.
"""

from __future__ import annotations

import os

import numpy as np


def write_csv(path: str, rows, columns) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, np.asarray(rows), fmt="%1.10f", header=",".join(columns),
               delimiter=",", comments="")


def read_csv(path: str) -> tuple[np.ndarray, list[str]]:
    with open(path) as f:
        header = f.readline().strip().split(",")
    data = np.loadtxt(path, delimiter=",", skiprows=1)
    return np.atleast_2d(data), header
