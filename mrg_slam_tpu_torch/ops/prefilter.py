"""Per-scan point-cloud conditioning (the Prefiltering component).

Counterpart of the JAX package's ops/prefilter.py, in the reference's stage
order (prefiltering_component.cpp:116-155): deskew -> base transform ->
distance filter -> voxel downsample -> RADIUS or STATISTICAL outlier
removal. Clouds may carry leading batch dims, so a block of scans filters
in one pass.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import PrefilterConfig
from ..utils import se3
from . import knn, voxel
from .cloud import PointCloud, compact, pad_invalid


def distance_filter(cloud: PointCloud, near: float, far: float) -> PointCloud:
    """Keep points with near < ||p|| < far (prefiltering_component.cpp:206),
    measured in the sensor/base frame."""
    d = torch.sqrt(torch.sum(cloud.points * cloud.points, dim=-1))
    mask = cloud.mask & (d > near) & (d < far)
    return PointCloud(pad_invalid(cloud.points, mask), mask)


def statistical_outlier_mask(cloud: PointCloud, mean_k: int,
                             stddev_mult: float) -> torch.Tensor:
    """pcl::StatisticalOutlierRemoval semantics
    (prefiltering_component.cpp:182-193): each point's mean distance to
    its mean_k nearest neighbours (the first of mean_k + 1, itself, left
    out); a point is dropped when that exceeds the mean over the cloud's
    valid points plus stddev_mult standard deviations."""
    d2, _ = knn.knn(cloud.points, cloud.points, cloud.mask, mean_k + 1)
    mean_d = torch.sqrt(torch.clamp(d2[..., 1:], min=0.0)).mean(-1)
    valid = cloud.mask
    zero = torch.zeros_like(mean_d)
    n = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    mu = torch.where(valid, mean_d, zero).sum(-1, keepdim=True) / n
    var = torch.where(valid, (mean_d - mu) ** 2, zero).sum(-1,
                                                           keepdim=True) / n
    return valid & (mean_d <= mu + stddev_mult * torch.sqrt(var))


def deskew(cloud: PointCloud, point_time_frac: torch.Tensor,
           ang_vel: torch.Tensor, scan_period: float) -> PointCloud:
    """Constant-angular-velocity rotation unwarp
    (prefiltering_component.cpp:231-258): each point rotates back by the
    rotation accumulated since the scan began, so3_exp(-omega t_i) with
    t_i = point_time_frac_i * scan_period.

    The rotation touches raw coordinates (~45 m), so its product is
    written as float32 multiply-adds: no reduced-precision contraction
    can round the near-identity rotation's dominant term.
    """
    ang = point_time_frac[..., None] * scan_period * ang_vel[..., None, :]
    R = se3.so3_exp(-ang)
    p = cloud.points
    pts = (R[..., 0] * p[..., 0:1] + R[..., 1] * p[..., 1:2]
           + R[..., 2] * p[..., 2:3])
    return PointCloud(pad_invalid(pts, cloud.mask), cloud.mask)


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

    `base_transform` is the sensor->base_link pose (7-vector). With
    `cfg.enable_deskewing`, `ang_vel` (3,) and `point_time_frac` (N,) (each
    point's time in the sweep, 0..1) deskew the scan first.
    """
    if cfg.enable_deskewing and ang_vel is not None \
            and point_time_frac is not None:
        cloud = deskew(cloud, point_time_frac, ang_vel, cfg.scan_period)
    cloud = downsample_stage(cloud, cfg, base_transform)
    if cfg.outlier_removal_method == "RADIUS":
        counts = knn.radius_count(cloud.points, cloud.mask, cfg.radius_radius)
        mask = cloud.mask & (counts >= cfg.radius_min_neighbors)
    elif cfg.outlier_removal_method == "STATISTICAL":
        mask = statistical_outlier_mask(cloud, cfg.statistical_mean_k,
                                        cfg.statistical_stddev)
    else:
        return cloud
    return PointCloud(pad_invalid(cloud.points, mask), mask)
