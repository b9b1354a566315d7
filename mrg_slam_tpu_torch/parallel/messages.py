"""Inter-robot message contract (the mrg_slam_msgs equivalent).

Counterpart of the JAX package's parallel/messages.py: the reference's
IDL field for field as plain dataclasses (usage evidence:
apps/mrg_slam_component.cpp:1172-1232, :450-455, :225-227). Robots in one
process hand each other these records as they are: a keyframe's cloud
stays the `PointCloud` on the card it was made as, so an in-process
exchange copies nothing. `quantize_graph_msg` makes the wire form a
socket transport sends (clouds as uint16 offsets on the host), and
`dequantize_graph_msg` puts them back on a device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..ops.cloud import PointCloud
from ..runtime import DeviceLike


@dataclasses.dataclass
class QuantizedCloud:
    """Wire form of a keyframe cloud: valid points only, uint16 offsets
    from the cloud's min corner at `scale` metres a step.

    The reference ships full float clouds a keyframe, and they dominate
    the exchange's bytes (mrg_slam_component.cpp:631-637). 4 mm steps are
    an order of magnitude below the working voxel sizes (0.1-0.3 m) and
    the GICP correspondence radii, at ~4x fewer bytes (12 B a point and
    the pad rows -> 6 B a valid point)."""

    offsets: np.ndarray   # (n, 3) uint16
    origin: np.ndarray    # (3,) f32 min corner
    scale: float          # metres a quantization step
    capacity: int         # the cloud's padded capacity

    @property
    def nbytes(self) -> int:
        return int(self.offsets.nbytes + 16)


def quantize_cloud(cloud: PointCloud, scale: float = 1.0 / 256.0
                   ) -> QuantizedCloud:
    """The cloud's wire form, computed on the host in numpy as the JAX
    package computes it (one read of the cloud)."""
    pts = cloud.points.cpu().numpy()
    mask = cloud.mask.cpu().numpy()
    valid = pts[mask]
    origin = (valid.min(axis=0) if len(valid)
              else np.zeros(3)).astype(np.float32)
    q = np.clip(np.round((valid - origin) / scale), 0, 65535).astype(
        np.uint16)
    return QuantizedCloud(offsets=q, origin=origin, scale=scale,
                          capacity=cloud.capacity)


def dequantize_cloud(qc: QuantizedCloud, device: DeviceLike) -> PointCloud:
    """A padded cloud of the original capacity on `device`."""
    pts = qc.origin[None, :] + qc.offsets.astype(np.float32) * qc.scale
    return PointCloud.from_array(pts, capacity=qc.capacity, device=device)


def quantize_graph_msg(msg: "GraphMsg") -> "GraphMsg":
    """The GraphMsg with its clouds in wire form and its estimates on the
    host; `wire_nbytes` records what it weighs on the wire."""
    kfs = [dataclasses.replace(
        k, cloud=(k.cloud if isinstance(k.cloud, QuantizedCloud)
                  else quantize_cloud(k.cloud)),
        estimate=np.asarray(k.estimate)) for k in msg.keyframes]
    out = dataclasses.replace(msg, keyframes=kfs)
    out.wire_nbytes = dataclasses.replace(out, wire_nbytes=0).nbytes()
    return out


def dequantize_graph_msg(msg: "GraphMsg", device: DeviceLike) -> "GraphMsg":
    """The GraphMsg with its wire-form clouds as padded clouds on
    `device`; `wire_nbytes` is kept."""
    kfs = [dataclasses.replace(
        k, cloud=(dequantize_cloud(k.cloud, device)
                  if isinstance(k.cloud, QuantizedCloud) else k.cloud))
        for k in msg.keyframes]
    return dataclasses.replace(msg, keyframes=kfs)


@dataclasses.dataclass
class KeyFrameMsg:
    robot_name: str
    uuid: str
    slam_uuid: str
    stamp: float
    odom_counter: int
    first_keyframe: bool
    static_keyframe: bool
    accum_distance: float
    estimate: np.ndarray          # (7,) current graph estimate
    cloud: object                 # PointCloud, or QuantizedCloud on the wire


@dataclasses.dataclass
class EdgeMsg:
    type: str                     # anchor | odom | loop
    uuid: str
    from_uuid: str
    to_uuid: str
    relative_pose: np.ndarray     # (7,)
    information: np.ndarray       # (6, 6)


@dataclasses.dataclass
class GraphMsg:
    robot_name: str
    latest_keyframe_uuid: str
    latest_keyframe_odom: np.ndarray
    keyframes: List[KeyFrameMsg]
    edges: List[EdgeMsg]
    # bytes that crossed the wire (set by quantize_graph_msg, kept through
    # dequantize_graph_msg); 0 for the zero-copy in-process exchange
    wire_nbytes: int = 0

    def nbytes(self) -> int:
        """Payload accounting (mrg_slam_component.cpp:631-637), from the
        tensors' shapes (`.nbytes`): it reads nothing from the card. The
        JAX package found a per-cloud fetch here to be 4.2 s of an 8.1 s
        two-robot run (its messages.py:117-121)."""
        if self.wire_nbytes:
            return self.wire_nbytes
        total = 0
        for k in self.keyframes:
            if isinstance(k.cloud, QuantizedCloud):
                total += k.cloud.nbytes + 7 * 4 + 64
            else:
                total += int(k.cloud.points.nbytes + k.cloud.mask.nbytes
                             + 7 * 4 + 64)
        total += len(self.edges) * (7 * 4 + 36 * 4 + 48)
        return total


@dataclasses.dataclass
class PoseWithName:
    robot_name: str
    stamp: float
    pose: np.ndarray              # (7,)
    accum_dist: float


@dataclasses.dataclass
class SlamStatus:
    """Heartbeat mirror of mrg_slam_msgs/SlamStatus."""

    robot_name: str = ""
    initialized: bool = False
    in_graph_exchange: bool = False
    in_loop_closure: bool = False
    in_optimization: bool = False


@dataclasses.dataclass
class PublishGraphRequest:
    """Delta-graph request: the uuids the requester already has (srv
    PublishGraph, mrg_slam_component.cpp:1153-1246)."""

    robot_name: str
    processed_keyframe_uuids: set
    processed_edge_uuids: set
