"""Map assembly (src/mrg_slam/map_cloud_generator.cpp).

Counterpart of the JAX package's models/map_cloud.py: every keyframe's
cloud is moved by its optimized pose, points beyond `distance_far_thresh`
of their sensor origin are culled, first keyframes are skipped on request
(their clouds still hold other robots' bodies), and the result is
voxel-downsampled (ops/voxel.py, the reference's ApproximateMeanVoxelGrid)
with a minimum number of points per voxel.

Keyframes go through in chunks of 64: each chunk is one batched transform
and one voxel pass, and the chunk maps are concatenated and voxelized
once more with the minimum-points gate, so a long mission's map never
holds every keyframe's cloud on the device at once.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cloud import PAD_VALUE, PointCloud
from ..ops.voxel import voxel_downsample
from ..utils import se3


def assemble_map(points: torch.Tensor, masks: torch.Tensor,
                 poses: torch.Tensor, skip: torch.Tensor, far_thresh: float,
                 resolution: float, min_points: int,
                 capacity: int) -> PointCloud:
    """points (K, P, 3), masks (K, P), poses (K, 7), skip (K,) -> the
    chunk's map cloud of `capacity` lanes."""
    local_d = torch.linalg.vector_norm(points, dim=-1)
    keep = masks & (local_d < far_thresh) & ~skip[:, None]
    world = se3.pose_apply(poses[:, None, :], points)
    world = torch.where(keep[..., None], world,
                        torch.full_like(world, PAD_VALUE))
    flat = PointCloud(world.reshape(-1, 3), keep.reshape(-1))
    return voxel_downsample(flat, resolution, min_points=min_points,
                            capacity=capacity)


def _valid_points(cloud: PointCloud) -> np.ndarray:
    return cloud.points[cloud.mask].cpu().numpy()


class MapCloudGenerator:
    def __init__(self, resolution: float, min_points_per_voxel: int,
                 distance_far_thresh: float, capacity: int = 1 << 20,
                 keyframes_per_chunk: int = 64):
        self.resolution = float(resolution)
        self.min_points = int(min_points_per_voxel)
        self.far_thresh = float(distance_far_thresh)
        self.capacity = int(capacity)
        self.chunk = int(keyframes_per_chunk)

    @classmethod
    def of_config(cls, cfg: SlamConfig) -> "MapCloudGenerator":
        return cls(cfg.map_cloud_resolution,
                   cfg.map_cloud_min_points_per_voxel,
                   cfg.map_cloud_distance_far_thresh)

    def generate(self, clouds: Sequence[PointCloud], poses: np.ndarray,
                 skip_first: bool = True,
                 first_flags: Optional[Sequence[bool]] = None
                 ) -> np.ndarray:
        """The assembled map as a dense (M, 3) numpy array."""
        if not clouds:
            return np.zeros((0, 3), np.float32)
        first_flags = (list(first_flags) if first_flags is not None
                       else [False] * len(clouds))
        dev = clouds[0].points.device
        parts: List[np.ndarray] = []
        for s in range(0, len(clouds), self.chunk):
            chunk = clouds[s: s + self.chunk]
            # a filled first keyframe's cloud is larger: pad the others
            cap = max(c.capacity for c in chunk)
            pts = torch.stack([torch.nn.functional.pad(
                c.points, (0, 0, 0, cap - c.capacity), value=PAD_VALUE)
                for c in chunk])
            msk = torch.stack([torch.nn.functional.pad(
                c.mask, (0, cap - c.capacity)) for c in chunk])
            pse = torch.from_numpy(np.asarray(poses[s: s + self.chunk],
                                              np.float32)).to(dev)
            skp = torch.tensor([skip_first and f
                                for f in first_flags[s: s + self.chunk]],
                               dtype=torch.bool, device=dev)
            sub = assemble_map(pts, msk, pse, skp, self.far_thresh,
                               self.resolution, 1,
                               capacity=min(self.capacity,
                                            pts.shape[0] * pts.shape[1]))
            parts.append(_valid_points(sub))
        merged = np.concatenate(parts, axis=0)
        cap = 1 << max(int(np.ceil(np.log2(max(len(merged), 2)))), 1)
        pc = PointCloud.from_array(merged, capacity=cap, device=dev)
        out = voxel_downsample(pc, self.resolution,
                               min_points=self.min_points, capacity=cap)
        return _valid_points(out)

    def from_store(self, db, skip_first: bool = True) -> np.ndarray:
        """One map over every odometry keyframe of a GraphDatabase (all
        robots' chains) at its optimized pose."""
        kfs = [k for k in db.keyframes + db.new_keyframes
               if k.node_id is not None and k.odom_counter >= 0]
        if not kfs:
            return np.zeros((0, 3), np.float32)
        poses = np.stack([k.estimate(db.graph) for k in kfs])
        return self.generate([k.cloud for k in kfs], poses,
                             skip_first=skip_first,
                             first_flags=[k.first_keyframe for k in kfs])
