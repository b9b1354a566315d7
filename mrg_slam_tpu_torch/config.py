"""Configuration of the front end (prefiltering, registration, odometry)
and of the single-robot back end (keyframes, loop closure, the pose-graph
solver).

Field names and defaults are those of the JAX package's dataclasses, which
mirror the reference's canonical YAML (mrg_slam.yaml:41-243), so that a
config written for one package reads unchanged in the other
(`convert.config_from_fields`), and the reference's own YAML with its
`<section>: {ros__parameters: {...}}` layout builds an `EngineConfig`
(`EngineConfig.from_yaml_dict`, the launch CLI's `--config`).
`capacity_*` fields size the padded clouds and the graph stores.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .utils.se3np import rpy_to_quat


def _replace_from_dict(obj, d: dict):
    """`obj` with the fields its dataclass declares taken from `d`; the
    other keys of `d` are ignored."""
    names = {f.name for f in dataclasses.fields(obj)}
    return dataclasses.replace(
        obj, **{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class StaticTransformConfig:
    """lidar2base_publisher section (mrg_slam.yaml:10-22): the static
    sensor->base_link transform applied during prefiltering."""

    enable_lidar2base_publisher: bool = True
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    roll: float = 0.0
    pitch: float = 0.0
    yaw: float = 0.0

    def pose7(self) -> np.ndarray:
        """The transform as a float32 7-vector [x y z, qw qx qy qz]."""
        return np.concatenate([np.asarray([self.x, self.y, self.z],
                                          np.float32),
                               rpy_to_quat(self.roll, self.pitch, self.yaw)])


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


@dataclass(frozen=True)
class FloorDetectionConfig:
    """Mirrors floor_detection_component params (mrg_slam.yaml:113-123).

    `pipeline.replay.Robot` runs floor detection
    (models/floor_detection.py) when it is enabled.
    """

    enable_floor_detection: bool = False
    tilt_deg: float = 0.0
    sensor_height: float = 2.0
    height_clip_range: float = 1.0
    floor_pts_thresh: int = 512
    floor_normal_thresh_deg: float = 10.0
    enable_normal_filtering: bool = True
    normal_filter_thresh_deg: float = 20.0
    ransac_iterations: int = 256
    ransac_distance_thresh: float = 0.1


@dataclass(frozen=True)
class LoopClosureConfig:
    """Loop-closure params of mrg_slam_component (mrg_slam.yaml:167-180)."""

    candidate_max_xy_distance: float = 15.0
    accum_distance_thresh_same_robot: float = 15.0
    accum_distance_thresh_other_robot: float = 5.0
    fitness_score_max_range: float = math.inf  # config/mrg_slam.yaml:172
    fitness_score_thresh: float = 1.25
    use_planar_registration_guess: bool = False
    loop_closure_edge_robust_kernel: str = "Huber"
    loop_closure_edge_robust_kernel_size: float = 1.0
    enable_loop_closure_consistency_check: bool = True
    loop_closure_consistency_max_delta_trans: float = 0.3
    loop_closure_consistency_max_delta_angle: float = 0.0523599
    # candidates matched per new keyframe per tick (the closest ones)
    capacity_candidates: int = 8


@dataclass(frozen=True)
class InformationMatrixConfig:
    """Mirrors information-matrix params (mrg_slam.yaml:215-224)."""

    use_const_inf_matrix: bool = False
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 2.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 0.75
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_thresh: float = 1.25  # shared with loop config in reference


@dataclass(frozen=True)
class GpsConfig:
    enable_gps: bool = False
    gps_edge_robust_kernel: str = "NONE"
    gps_edge_robust_kernel_size: float = 1.0
    gps_edge_stddev_xy: float = 20.0
    gps_edge_stddev_z: float = 5.0
    gps_use_enu: bool = False
    gps_enu_origin_from_msg: bool = True
    gps_enu_origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    gps_time_tolerance: float = 0.2


@dataclass(frozen=True)
class ImuConfig:
    enable_imu_orientation: bool = False
    imu_orientation_edge_robust_kernel: str = "NONE"
    imu_orientation_edge_stddev: float = 1.0
    enable_imu_acceleration: bool = False
    imu_acceleration_edge_robust_kernel: str = "NONE"
    imu_acceleration_edge_stddev: float = 1.0
    imu_time_tolerance: float = 0.2


@dataclass(frozen=True)
class FloorCoeffsConfig:
    enable_floor_coeffs: bool = False
    floor_edge_robust_kernel: str = "NONE"
    floor_edge_stddev: float = 10.0


@dataclass(frozen=True)
class OptimizerConfig:
    """Pose-graph solver settings (g2o_* params, mrg_slam.yaml:152-155)."""

    g2o_solver_type: str = "lm_var_cholmod"  # read for the lm/gn choice
    g2o_solver_num_iterations: int = 512  # outer cap; stops on chi2 gain
    g2o_verbose: bool = False
    # LM stops once an accepted step gains less than this relative chi2
    chi2_rel_tol: float = 1e-6
    lm_initial_lambda: float = 1e-6
    # dense | cg | chain | auto (dense while 6N+3P <= auto_dense_max_dofs);
    # (graph/solve.py)
    solver_backend: str = "auto"
    auto_dense_max_dofs: int = 12288
    cg_max_iterations: int = 256
    cg_tol: float = 1e-6
    # per-tick marginal covariances: none | approx (block-Jacobi) | exact
    # (dense H^-1) | cg | auto (exact up to 4096 dofs, cg beyond)
    per_tick_marginals: str = "auto"
    chordal_init: bool = False


@dataclass(frozen=True)
class GraphExchangeConfig:
    """Multi-robot exchange params (mrg_slam.yaml:226-231)."""

    graph_exchange_mode: str = "PATH_PROXIMITY"
    graph_request_min_accum_dist: float = 2.0
    graph_request_max_robot_dist: float = 50.0
    graph_request_min_time_delay: float = 2.0


@dataclass(frozen=True)
class SlamConfig:
    """Mirrors mrg_slam_component params (mrg_slam.yaml:126-243)."""

    enable_mrg_slam: bool = True
    own_name: str = "atlas"
    multi_robot_names: Tuple[str, ...] = ("atlas", "bestla")
    robot_remove_points_radius: float = 2.0
    init_pose: Tuple[float, float, float, float, float, float] = (
        0.0, 0.0, 0.0, 0.0, 0.0, 0.0)  # x y z yaw pitch roll (launch order)
    enable_fill_first_cloud: bool = False
    fill_first_cloud_radius: float = 5.0
    fill_first_cloud_simple: bool = False
    max_keyframes_per_update: int = 10000
    keyframe_delta_trans: float = 1.0
    keyframe_delta_angle: float = 0.5236
    use_custom_inf_matrix_first_node: bool = True
    custom_inf_matrix_first_node_stddev: Tuple[float, ...] = (
        0.75, 0.75, 0.75, 0.1, 0.1, 0.1)
    odometry_edge_robust_kernel: str = "NONE"
    odometry_edge_robust_kernel_size: float = 1.0
    graph_update_interval: float = 3.0
    map_cloud_update_interval: float = 5.0
    map_cloud_resolution: float = 0.1
    map_cloud_min_points_per_voxel: int = 1
    map_cloud_distance_far_thresh: float = 10000.0
    result_dir: str = ""

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    loop: LoopClosureConfig = field(default_factory=LoopClosureConfig)
    inf_matrix: InformationMatrixConfig = field(
        default_factory=InformationMatrixConfig)
    registration: RegistrationConfig = field(
        default_factory=RegistrationConfig)
    gps: GpsConfig = field(default_factory=GpsConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    floor_coeffs: FloorCoeffsConfig = field(default_factory=FloorCoeffsConfig)
    exchange: GraphExchangeConfig = field(
        default_factory=GraphExchangeConfig)

    capacity_keyframes: int = 2048
    capacity_edges: int = 8192
    capacity_keyframe_points: int = 8192  # stored per-keyframe cloud budget


@dataclass(frozen=True)
class EngineConfig:
    """Top-level config bundle for one robot's SLAM stack."""

    model_namespace: str = "atlas"
    lidar2base: StaticTransformConfig = field(
        default_factory=StaticTransformConfig)
    prefilter: PrefilterConfig = field(default_factory=PrefilterConfig)
    odometry: ScanMatchingOdometryConfig = field(
        default_factory=ScanMatchingOdometryConfig)
    floor: FloorDetectionConfig = field(default_factory=FloorDetectionConfig)
    slam: SlamConfig = field(default_factory=SlamConfig)

    def with_overrides(self, **kwargs) -> "EngineConfig":
        return dataclasses.replace(self, **kwargs)

    @staticmethod
    def from_yaml_dict(d: dict) -> "EngineConfig":
        """Build from a dict shaped like the reference YAML (section ->
        params), as the JAX package's does (config.py:337-380).

        Takes the `<section>: {ros__parameters: {...}}` nesting of
        config/mrg_slam.yaml as well as flat `<section>: {...}` dicts.
        Each component section fills every dataclass below it from one
        flat namespace (the odometry's registration from
        `scan_matching_odometry_component`, the back end's optimizer,
        loop, information-matrix, registration, GPS, IMU, floor and
        exchange configs from `mrg_slam_component`); `/**` carries
        `model_namespace`; a key no dataclass declares is ignored.
        """
        def params(section: str) -> dict:
            sec = d.get(section, {}) or {}
            return sec.get("ros__parameters", sec)

        cfg = EngineConfig()
        l2b = _replace_from_dict(cfg.lidar2base,
                                 params("lidar2base_publisher"))
        pre = _replace_from_dict(cfg.prefilter,
                                 params("prefiltering_component"))
        odo_p = params("scan_matching_odometry_component")
        odo = dataclasses.replace(
            _replace_from_dict(cfg.odometry, odo_p),
            registration=_replace_from_dict(cfg.odometry.registration,
                                            odo_p))
        flo = _replace_from_dict(cfg.floor,
                                 params("floor_detection_component"))
        slam_p = params("mrg_slam_component")
        s = cfg.slam
        slam = dataclasses.replace(
            _replace_from_dict(s, slam_p),
            multi_robot_names=tuple(slam_p.get("multi_robot_names",
                                               s.multi_robot_names)),
            **{name: _replace_from_dict(getattr(s, name), slam_p)
               for name in ("optimizer", "loop", "inf_matrix",
                            "registration", "gps", "imu", "floor_coeffs",
                            "exchange")})
        ns = params("/**").get("model_namespace", cfg.model_namespace)
        return EngineConfig(model_namespace=ns, lidar2base=l2b,
                            prefilter=pre, odometry=odo, floor=flo,
                            slam=slam)
