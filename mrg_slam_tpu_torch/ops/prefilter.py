"""Per-scan point-cloud conditioning (the Prefiltering component).

Counterpart of the JAX package's ops/prefilter.py, in the reference's stage
order (prefiltering_component.cpp:116-155): base transform -> distance
filter -> voxel downsample -> RADIUS outlier removal. Clouds may carry
leading batch dims, so a block of scans filters in one pass.

Deskewing and STATISTICAL outlier removal are not ported yet (ROADMAP.md,
queue 1 item 10); asking for them raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PrefilterConfig
from . import knn, voxel
from .cloud import PointCloud, compact, pad_invalid

_LATER = "not ported yet: ROADMAP.md queue 1 item 10 ports it"


def distance_filter(cloud: PointCloud, near: float, far: float) -> PointCloud:
    """Keep points with near < ||p|| < far (prefiltering_component.cpp:206),
    measured in the sensor/base frame."""
    d = torch.sqrt(torch.sum(cloud.points * cloud.points, dim=-1))
    mask = cloud.mask & (d > near) & (d < far)
    return PointCloud(pad_invalid(cloud.points, mask), mask)


def downsample_stage(cloud: PointCloud, cfg: PrefilterConfig,
                     base_transform: Optional[torch.Tensor] = None
                     ) -> PointCloud:
    """The stages before outlier removal: base transform, distance filter,
    downsample. Its output is what RADIUS removal counts on."""
    if base_transform is not None:
        cloud = cloud.transformed(base_transform)
    if cfg.enable_distance_filter:
        cloud = distance_filter(cloud, cfg.distance_near_thresh,
                                cfg.distance_far_thresh)
    if cfg.downsample_method in ("VOXELGRID", "APPROX_VOXELGRID"):
        return voxel.voxel_downsample(
            cloud, cfg.downsample_resolution,
            min_points=cfg.downsample_min_points_per_voxel,
            capacity=cfg.capacity_filtered_points, absolute_origin=True)
    return compact(cloud, cfg.capacity_filtered_points)


def prefilter(cloud: PointCloud, cfg: PrefilterConfig,
              base_transform: Optional[torch.Tensor] = None,
              ang_vel: Optional[torch.Tensor] = None,
              point_time_frac: Optional[torch.Tensor] = None) -> PointCloud:
    """Full prefiltering; returns a cloud of `cfg.capacity_filtered_points`
    lanes (with VOXELGRID) on the input's device.

    `base_transform` is the sensor->base_link pose (7-vector).
    """
    if cfg.enable_deskewing and ang_vel is not None \
            and point_time_frac is not None:
        raise NotImplementedError(f"deskewing is {_LATER}")
    cloud = downsample_stage(cloud, cfg, base_transform)
    if cfg.outlier_removal_method == "RADIUS":
        counts = knn.radius_count(cloud.points, cloud.mask, cfg.radius_radius)
        mask = cloud.mask & (counts >= cfg.radius_min_neighbors)
        cloud = PointCloud(pad_invalid(cloud.points, mask), mask)
    elif cfg.outlier_removal_method == "STATISTICAL":
        raise NotImplementedError(f"STATISTICAL outlier removal is {_LATER}")
    return cloud
