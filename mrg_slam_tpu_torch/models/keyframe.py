"""KeyFrame and Edge records (host-side, clouds on the device).

Counterpart of the JAX package's models/keyframe.py, which mirrors
include/mrg_slam/keyframe.hpp:71-104 and edge.hpp:28-94: uuid-keyed
pose-graph node and edge bookkeeping. The g2o vertex and edge pointers
become dense integer ids into the GraphSLAM builder; clouds are padded
tensors on the device.
"""

from __future__ import annotations

import dataclasses
import uuid as uuid_mod
from typing import Optional

import numpy as np

from ..ops.cloud import PointCloud
from ..ops.covariance import GICPCloud
from ..ops.gaussian_voxel import GaussianVoxelMap

EDGE_ANCHOR = "anchor"
EDGE_ODOM = "odom"
EDGE_LOOP = "loop"


def new_uuid() -> str:
    return str(uuid_mod.uuid4())


@dataclasses.dataclass
class KeyFrame:
    robot_name: str
    stamp: float
    odom: np.ndarray                 # (7,) odometry-frame pose
    accum_distance: float
    cloud: PointCloud
    uuid: str = dataclasses.field(default_factory=new_uuid)
    slam_uuid: str = ""              # per-run graph id of the originating slam
    odom_counter: int = 0
    first_keyframe: bool = False
    static_keyframe: bool = False
    node_id: Optional[int] = None    # graph node index once flushed
    # the saved estimate a loaded keyframe's node is created at
    # (estimate_transform, graph_database.cpp:500)
    estimate_loaded: Optional[np.ndarray] = None
    # the cloud with its GICP covariances, made once for the pair program
    # (models/pair_runner.py) or handed over by the front end
    gicp: Optional[GICPCloud] = None
    # its Gaussian voxel map, made once for the pair program with a
    # voxel-family method (models/pair_runner.py)
    voxel_map: Optional[GaussianVoxelMap] = None
    # sensor attachments (keyframe.cpp:88-104): set by the processors'
    # flushes (models/processors.py)
    floor_coeffs: Optional[np.ndarray] = None
    utm_coord: Optional[np.ndarray] = None
    acceleration: Optional[np.ndarray] = None   # (3,) base-frame acc
    orientation: Optional[np.ndarray] = None    # (4,) wxyz base-frame quat
    prev_edge: Optional["Edge"] = None  # odom edge (from=this, to=prev kf)
    next_edge: Optional["Edge"] = None  # odom edge (from=next kf, to=this)

    @property
    def readable_id(self) -> str:
        return f"{self.robot_name}.{self.odom_counter}"

    def estimate(self, graph) -> np.ndarray:
        """Current optimized pose from the graph builder (7,)."""
        if self.node_id is None:
            return np.asarray(self.odom, np.float32)
        return graph.poses[self.node_id]


@dataclasses.dataclass
class Edge:
    type: str                        # EDGE_ANCHOR | EDGE_ODOM | EDGE_LOOP
    from_uuid: str
    to_uuid: str
    relative_pose: np.ndarray        # (7,) T_from^-1 T_to
    information: np.ndarray          # (6,6)
    uuid: str = dataclasses.field(default_factory=new_uuid)
    edge_id: Optional[int] = None    # index in the GraphSLAM se3 table
    from_readable: str = ""
    to_readable: str = ""
    robust_kernel: str = "NONE"      # persisted like robust_kernel_io.cpp
    robust_kernel_size: float = 1.0

    @property
    def readable_id(self) -> str:
        return f"{self.type}:{self.from_readable}->{self.to_readable}"
