"""Configuration of the front end: prefiltering, registration, odometry.

Field names and defaults are those of the JAX package's dataclasses, which
mirror the reference's canonical YAML (mrg_slam.yaml:41-110), so that a
config written for one package reads unchanged in the other
(`convert.config_from_fields`). `capacity_*` fields size the padded clouds.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class PrefilterConfig:
    """Mirrors prefiltering_component params (mrg_slam.yaml:41-72)."""

    enable_prefiltering: bool = True
    downsample_method: str = "VOXELGRID"  # VOXELGRID | APPROX_VOXELGRID | NONE
    downsample_resolution: float = 0.1
    downsample_min_points_per_voxel: int = 1
    outlier_removal_method: str = "RADIUS"  # STATISTICAL | RADIUS | NONE
    statistical_mean_k: int = 30
    statistical_stddev: float = 1.2
    radius_radius: float = 0.5
    radius_min_neighbors: int = 2
    enable_distance_filter: bool = True
    distance_near_thresh: float = 0.1
    distance_far_thresh: float = 35.0
    enable_deskewing: bool = False
    scan_period: float = 0.1
    capacity_raw_points: int = 131072
    capacity_filtered_points: int = 32768


@dataclass(frozen=True)
class RegistrationConfig:
    """Mirrors the reg_* parameter block (mrg_slam.yaml:100-110,181-190)."""

    registration_method: str = "SMALL_GICP"  # SMALL_GICP|GICP|VGICP|NDT|ICP
    reg_num_threads: int = 8  # unused: the card owns parallelism
    reg_transformation_epsilon: float = 0.1
    reg_maximum_iterations: int = 64
    reg_max_correspondence_distance: float = 2.0
    reg_max_optimizer_iterations: int = 20
    reg_use_reciprocal_correspondences: bool = False
    reg_correspondence_randomness: int = 20  # k for kNN GICP covariances
    reg_resolution: float = 1.0  # NDT / VGICP voxel size
    reg_nn_search_method: str = "DIRECT7"  # DIRECT1 | DIRECT7 | DIRECT27
    reg_ndt_outlier_ratio: float = 0.55
    # GICP covariance neighbourhoods: "knn" (k = reg_correspondence_
    # randomness) or "radius" (one-pass radius moments)
    reg_covariance_mode: str = "radius"
    reg_covariance_radius: float = 1.0
    # coarse-to-fine Gauss-Newton: the first reg_coarse_iterations run on
    # stride-subsampled clouds; stride 1 disables
    reg_coarse_stride: int = 1
    reg_coarse_iterations: int = 0
    # stall exit: a solve whose mean error improves by less than this
    # relative fraction for 2 consecutive iterations stops; 0 disables
    reg_stall_epsilon: float = 0.0


@dataclass(frozen=True)
class ScanMatchingOdometryConfig:
    """Mirrors scan_matching_odometry_component params (mrg_slam.yaml:75-110)."""

    enable_scan_matching_odometry: bool = True
    keyframe_delta_translation: float = 1.0
    keyframe_delta_angle: float = 0.5236
    keyframe_delta_time: float = 10000.0
    enable_transform_thresholding: bool = False
    max_acceptable_translation: float = 1.0
    max_acceptable_angle: float = 1.0
    max_consecutive_rejections: int = 5
    enable_imu_frontend: bool = False
    enable_robot_odometry_init_guess: bool = False
    downsample_method: str = "NONE"
    downsample_resolution: float = 0.1
    downsample_min_points_per_voxel: int = 1
    registration: RegistrationConfig = field(default_factory=RegistrationConfig)
