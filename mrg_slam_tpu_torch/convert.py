"""Carry state across from the JAX package: configs, the odometry carry
and pose graphs.

The system has no weights; its state is its configuration, the odometry
carry and the pose graph. All cross as plain Python and numpy values, so
this module needs nothing of the JAX package:

    cfg = config_from_fields(dataclasses.asdict(jax_cfg))
    carry = carry_from_numpy({k: np.asarray(v)
                              for k, v in jax_carry._asdict().items()})
    graph = graph_from_numpy(jax.tree.map(np.asarray, jax_graph))
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from . import config
from .graph.types import EDGE_TABLES, PoseGraphData
from .models.odometry_fused import OdomCarry
from .runtime import DeviceLike, resolve_device

_CONFIGS = tuple(v for v in vars(config).values()
                 if isinstance(v, type) and dataclasses.is_dataclass(v))


def config_from_fields(d: Mapping[str, Any]):
    """The port's config dataclass whose field names are exactly the keys of
    `d` (a `dataclasses.asdict` of the JAX package's config); nested
    configs (the mappings among the values) convert the same way."""
    keys = set(d)
    for cls in _CONFIGS:
        if keys == {f.name for f in dataclasses.fields(cls)}:
            return cls(**{k: config_from_fields(v) if isinstance(v, Mapping)
                          else v for k, v in d.items()})
    raise ValueError(f"no config of the port has the fields {sorted(keys)}")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def graph_from_numpy(g, device: DeviceLike = None) -> PoseGraphData:
    """A `PoseGraphData` from the JAX package's graph fetched as numpy
    arrays (a NamedTuple of the same field names, its edge tables
    NamedTuples too)."""
    dev = resolve_device(device)
    tables = {name: cls(**{f: _tensor(getattr(getattr(g, name), f), dev)
                           for f in cls._fields})
              for name, cls in EDGE_TABLES.items()}
    return PoseGraphData(**tables, **{
        f: _tensor(getattr(g, f), dev) for f in PoseGraphData._fields
        if f not in tables})


_CARRY_DTYPES = dict(target_mask=torch.bool, initialized=torch.bool,
                     rejections=torch.int32)


def carry_from_numpy(d, device: DeviceLike = None) -> OdomCarry:
    """An `OdomCarry` from the JAX package's carry fetched as numpy arrays
    (a mapping or a NamedTuple of the same field names)."""
    d = d._asdict() if hasattr(d, "_asdict") else dict(d)
    dev = resolve_device(device)
    return OdomCarry(**{
        f: torch.from_numpy(np.array(d[f])).to(
            dev, _CARRY_DTYPES.get(f, torch.float32))
        for f in OdomCarry._fields})
