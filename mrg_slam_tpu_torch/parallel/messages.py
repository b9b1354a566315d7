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
from typing import List, Tuple

import numpy as np
import torch

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


# metres a quantization step of the wire form (QuantizedCloud)
WIRE_SCALE = 1.0 / 256.0


def _quantize_host(pts: np.ndarray, mask: np.ndarray, capacity: int,
                   scale: float) -> QuantizedCloud:
    """The wire form of a cloud already on the host, as the JAX package
    computes it in numpy."""
    valid = pts[mask]
    origin = (valid.min(axis=0) if len(valid)
              else np.zeros(3)).astype(np.float32)
    q = np.clip(np.round((valid - origin) / scale), 0, 65535).astype(
        np.uint16)
    return QuantizedCloud(offsets=q, origin=origin, scale=scale,
                          capacity=capacity)


def quantize_cloud(cloud: PointCloud, scale: float = WIRE_SCALE
                   ) -> QuantizedCloud:
    """The cloud's wire form, computed on the host (one read of the
    cloud)."""
    (pts, mask), = _clouds_to_host([cloud])
    return _quantize_host(pts, mask, cloud.capacity, scale)


def _clouds_to_host(clouds: List[PointCloud]
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every cloud's (points, mask) as numpy, in one device->host copy:
    the clouds' bytes packed into one uint8 tensor on their device, read
    once, and cut up on the host. A read a cloud would sync the stream
    twice per keyframe of a delta graph."""
    if not clouds:
        return []
    # every cloud's points, then every mask: the float32 runs stay aligned
    parts = [c.points.reshape(-1).view(torch.uint8) for c in clouds]
    parts += [c.mask.reshape(-1).view(torch.uint8) for c in clouds]
    host = torch.cat(parts).cpu().numpy()
    out, at = [], sum(12 * c.capacity for c in clouds)
    pts = host[:at].view(np.float32)
    p0 = 0
    for c in clouds:
        n = c.capacity
        out.append((pts[p0:p0 + 3 * n].reshape(n, 3),
                    host[at:at + n].view(np.bool_)))
        p0, at = p0 + 3 * n, at + n
    return out


def dequantize_cloud(qc: QuantizedCloud, device: DeviceLike) -> PointCloud:
    """A padded cloud of the original capacity on `device`."""
    pts = qc.origin[None, :] + qc.offsets.astype(np.float32) * qc.scale
    return PointCloud.from_array(pts, capacity=qc.capacity, device=device)


def quantize_graph_msg(msg: "GraphMsg") -> "GraphMsg":
    """The GraphMsg with its clouds in wire form and its estimates on the
    host; `wire_nbytes` records what it weighs on the wire. Every cloud of
    the message comes off the device in one read (`_clouds_to_host`)."""
    todo = [k.cloud for k in msg.keyframes
            if not isinstance(k.cloud, QuantizedCloud)]
    host = iter(_clouds_to_host(todo))
    kfs = []
    for k in msg.keyframes:
        cloud = k.cloud
        if not isinstance(cloud, QuantizedCloud):
            pts, mask = next(host)
            cloud = _quantize_host(pts, mask, cloud.capacity, WIRE_SCALE)
        kfs.append(dataclasses.replace(k, cloud=cloud,
                                       estimate=np.asarray(k.estimate)))
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
