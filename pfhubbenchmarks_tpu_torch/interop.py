"""Carry the JAX package's data across, so both packages compute the same
thing: states as tuples of numpy arrays (2D pairs ``(v, m)``, 3D 1-tuples
``(v,)`` with v ``[F, Z, Y, X]``), configs as ``dataclasses.asdict`` dicts,
benchmark parameters as dicts of numpy or Python scalars (bench1_3d takes
``Bench1Params``, elast ``ElastParams``). Nothing here imports jax: the JAX
side hands over plain numpy and Python values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pfhubbenchmarks_tpu_torch.benchmarks.bench1 import Bench1Params
from pfhubbenchmarks_tpu_torch.benchmarks.bench2 import Bench2Params
from pfhubbenchmarks_tpu_torch.benchmarks.bench3 import Bench3Params
from pfhubbenchmarks_tpu_torch.benchmarks.bench6 import Bench6Params
from pfhubbenchmarks_tpu_torch.benchmarks.elast import ElastParams
from pfhubbenchmarks_tpu_torch.config import SolverConfig, TimeConfig


def state_from_numpy(w, device: torch.device | str, dtype=torch.float64):
    """(v, m) or (v,) of numpy (or array-like) arrays -> the same tuple of
    tensors on ``device`` (a copy: the source may be a read-only view of a
    JAX array)."""
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in w)


def state_to_numpy(w):
    """Tuple of tensors -> tuple of numpy arrays (copied to the host)."""
    return tuple(a.detach().cpu().numpy() for a in w)


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**{k: (v.item() if isinstance(v, np.generic) else v)
                  for k, v in d.items()})


def solver_config_from_dict(d: dict) -> SolverConfig:
    return _from_dict(SolverConfig, d)


def time_config_from_dict(d: dict) -> TimeConfig:
    return _from_dict(TimeConfig, d)


def problem_params_from_numpy(d: dict, params_cls=Bench1Params):
    """``dataclasses.asdict`` of a JAX benchmark's parameters (values may be
    numpy scalars) -> the port's ``params_cls`` (``Bench1Params``,
    ``Bench2Params``, ``Bench3Params``, ``Bench6Params`` or
    ``ElastParams``); the integer fields (bench3's ``m``) stay integers."""
    if params_cls not in (Bench1Params, Bench2Params, Bench3Params,
                          Bench6Params, ElastParams):
        raise ValueError(f"no ported parameters {params_cls!r}")
    ints = {f.name for f in dataclasses.fields(params_cls)
            if f.type in (int, "int")}
    return _from_dict(params_cls, {k: int(v) if k in ints else float(v)
                                   for k, v in d.items()})
