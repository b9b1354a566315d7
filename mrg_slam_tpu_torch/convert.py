"""Carry state across from the JAX package: configs and the odometry carry.

The front end has no weights; its state is its configuration and the
odometry carry. Both cross as plain Python and numpy values, so this module
needs nothing of the JAX package:

    cfg = config_from_fields(dataclasses.asdict(jax_cfg))
    carry = carry_from_numpy({k: np.asarray(v)
                              for k, v in jax_carry._asdict().items()})
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .config import (PrefilterConfig, RegistrationConfig,
                     ScanMatchingOdometryConfig)
from .models.odometry_fused import OdomCarry
from .runtime import DeviceLike, resolve_device

_CONFIGS = (PrefilterConfig, RegistrationConfig, ScanMatchingOdometryConfig)


def config_from_fields(d: Mapping[str, Any]):
    """The port's config dataclass whose field names are exactly the keys of
    `d` (a `dataclasses.asdict` of the JAX package's config)."""
    keys = set(d)
    for cls in _CONFIGS:
        if keys == {f.name for f in dataclasses.fields(cls)}:
            kw = dict(d)
            if cls is ScanMatchingOdometryConfig:
                kw["registration"] = config_from_fields(kw["registration"])
            return cls(**kw)
    raise ValueError(f"no config of the port has the fields {sorted(keys)}")


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
