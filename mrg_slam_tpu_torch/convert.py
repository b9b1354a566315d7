"""Carry state across from the JAX package: configs, the odometry carry
and pose graphs.

The system has no weights; its state is its configuration, the odometry
carry and the pose graph. All cross as plain Python and numpy values, so
this module needs nothing of the JAX package:

    cfg = config_from_fields(dataclasses.asdict(jax_cfg))
    carry = carry_from_numpy({k: np.asarray(v)
                              for k, v in jax_carry._asdict().items()})
    graph = graph_from_numpy(jax.tree.map(np.asarray, jax_graph))

A delta graph of the exchange crosses the same way: `graph_msg_from_numpy`
takes a GraphMsg of the JAX package whose clouds were fetched as numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from . import config
from .graph.types import EDGE_TABLES, PoseGraphData
from .models.odometry_fused import OdomCarry
from .ops.cloud import PointCloud
from .parallel import messages
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


def graph_msg_from_numpy(msg, device: DeviceLike = None
                         ) -> messages.GraphMsg:
    """The port's GraphMsg from the JAX package's (the same fields, its
    keyframe clouds' points and masks as numpy arrays, or QuantizedClouds
    of numpy arrays): clouds on the device, poses and information as
    float32 numpy."""
    dev = resolve_device(device)

    def cloud(c):
        if hasattr(c, "offsets"):
            return messages.QuantizedCloud(
                offsets=np.asarray(c.offsets), origin=np.asarray(c.origin),
                scale=float(c.scale), capacity=int(c.capacity))
        return PointCloud(_tensor(c.points, dev),
                          torch.from_numpy(np.array(c.mask, bool)).to(dev))

    kfs = [messages.KeyFrameMsg(
        robot_name=k.robot_name, uuid=k.uuid, slam_uuid=k.slam_uuid,
        stamp=float(k.stamp), odom_counter=int(k.odom_counter),
        first_keyframe=bool(k.first_keyframe),
        static_keyframe=bool(k.static_keyframe),
        accum_distance=float(k.accum_distance),
        estimate=np.asarray(k.estimate, np.float32), cloud=cloud(k.cloud))
        for k in msg.keyframes]
    edges = [messages.EdgeMsg(
        type=e.type, uuid=e.uuid, from_uuid=e.from_uuid, to_uuid=e.to_uuid,
        relative_pose=np.asarray(e.relative_pose, np.float32),
        information=np.asarray(e.information, np.float32))
        for e in msg.edges]
    return messages.GraphMsg(
        robot_name=msg.robot_name,
        latest_keyframe_uuid=msg.latest_keyframe_uuid,
        latest_keyframe_odom=np.asarray(msg.latest_keyframe_odom,
                                        np.float32),
        keyframes=kfs, edges=edges, wire_nbytes=int(msg.wire_nbytes))
