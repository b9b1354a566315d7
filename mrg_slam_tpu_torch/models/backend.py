"""The single-robot SLAM back end: keyframe admission, loop closure and
pose-graph optimization (MrgSlamComponent without ROS).

Counterpart of the single-robot main path of the JAX package's
models/backend.py. apps/mrg_slam_component.cpp's callbacks become methods:

- `process_scan`        <- cloud_callback (:358)
- `optimization_tick`   <- optimization_timer_callback (:802)
- `slam_pose_broadcast` <- the slam pose broadcast timer
- `generate_map`        <- map_points_publish_timer (:764)
- `save_map`            <- save_map_service (:1078-1098)

A tick runs its device work in two programs: the pair program (every
odometry edge's fitness, every loop candidate's registration and the
consistency checks, models/pair_runner.py) and the dense LM solve with
per-tick marginals (graph/solve.py). Its host reads: one per Gauss-Newton
sweep and one per pair bucket, one per LM iteration, and one packed read
of the solve's poses, chi2 and marginals.

The floor, GPS and IMU processors (models/processors.py) are flushed in
each tick after the keyframe queue, in the JAX package's order
(backend.py:241-244), and add their priors and plane edges to the graph.

Not ported yet, and refused by the constructor: other robots in
`multi_robot_names`, whose exchange services and asynchronous tick wait
for ROADMAP.md queue 1 item 14. Robots co-hosted on one card share one
graph through models/shared_graph.py instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..io.pcd import save_pcd
from ..ops.cloud import PointCloud
from ..ops.covariance import GICPCloud
from ..ops.stats_kernel import radius_sq
from ..parallel.messages import PoseWithName, SlamStatus
from ..runtime import DeviceLike
from ..utils import se3np
from .graph_database import GraphDatabase
from .keyframe_updater import KeyframeUpdater
from .loop_detector import LoopDetector
from .map_cloud import MapCloudGenerator
from .pair_runner import PairRequest
from .processors import FloorCoeffsProcessor, GpsProcessor, ImuProcessor


def _remove_points_near(points: torch.Tensor, mask: torch.Tensor,
                        centers: torch.Tensor, center_valid: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """The mask without the points within `radius` of any valid center
    (other-robot point removal, mrg_slam_component.cpp:375-443), in
    float32 as the JAX package computes it."""
    d2 = ((points[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(center_valid[None, :], d2,
                     torch.full_like(d2, float("inf")))
    return mask & ~(d2 <= radius_sq(radius)).any(-1)


@dataclasses.dataclass
class TickStats:
    """Per-tick instrumentation mirroring timing_stats.txt
    (mrg_slam_component.cpp:1016-1045)."""

    loop_closure_us: float = 0.0
    optimization_us: float = 0.0
    num_loops: int = 0
    chi2_before: float = 0.0
    chi2_after: float = 0.0
    iterations: int = 0
    lm_ms: float = 0.0         # snapshot upload and LM (graph/builder.py)
    marginals_ms: float = 0.0  # marginals and the solve's packed read
    # (rows, GN iterations of the slowest row) of each pair-program bucket
    pair_buckets: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


_LATER = "is not ported yet: it waits for ROADMAP.md queue 1 item"


def _flush_processors(db: GraphDatabase, procs, keyframes) -> bool:
    """The floor, GPS and IMU processors' flushes into the graph, in the
    JAX package's order; whether any added an edge."""
    flushed = False
    for proc in procs:
        flushed |= proc.flush(db, keyframes)
    return flushed


def _loops_and_solve(db: GraphDatabase, loop_detector: LoopDetector,
                     pre, statuses) -> TickStats:
    """A tick after its flushes (`pre` = (stats, deferred edges, their
    fitness requests) from a `_tick_begin`): the pair program, the new
    edges and accepted loops into the graph, and the LM solve, each
    status flagged while its stage runs."""
    stats, deferred, edge_reqs = pre
    for st in statuses:
        st.in_loop_closure = True
    runner = loop_detector.runner
    runner.buckets.clear()
    t0 = time.perf_counter()
    loops, edge_results = loop_detector.detect(db, edge_reqs)
    stats.loop_closure_us = (time.perf_counter() - t0) * 1e6
    stats.pair_buckets = list(runner.buckets)
    stats.num_loops = len(loops)
    for st in statuses:
        st.in_loop_closure = False
    db.finalize_edges(deferred, [r.fitness_inf for r in edge_results])
    db.insert_loops(loops)

    for st in statuses:
        st.in_optimization = True
    t0 = time.perf_counter()
    db.optimize()
    stats.optimization_us = (time.perf_counter() - t0) * 1e6
    for st in statuses:
        st.in_optimization = False
    stats.chi2_before = db.graph.chi2_initial
    stats.chi2_after = db.graph.chi2_final
    stats.iterations = db.graph.last_iterations
    stats.lm_ms = db.graph.last_lm_ms
    stats.marginals_ms = db.graph.last_marginals_ms
    return stats


class MrgSlam:
    """One robot's SLAM back end, on the card unless `device` says
    otherwise."""

    MAX_OTHER_ROBOTS = 8  # point-removal centers per scan

    def __init__(self, cfg: SlamConfig, device: DeviceLike = None):
        others = sorted(set(cfg.multi_robot_names) - {cfg.own_name})
        if others:
            raise NotImplementedError(
                f"other robots {others} in multi_robot_names: the graph "
                f"exchange {_LATER} 14; give multi_robot_names=(own_name,), "
                "or co-host the robots in models.shared_graph."
                "SharedGraphSlam")
        self.cfg = cfg
        self.own_name = cfg.own_name
        self.db = GraphDatabase(cfg, device=device)
        self.loop_detector = LoopDetector(cfg.loop, cfg.registration)
        self.keyframe_updater = KeyframeUpdater(cfg.keyframe_delta_trans,
                                                cfg.keyframe_delta_angle)
        self.map_generator = MapCloudGenerator.of_config(cfg)
        self.status = SlamStatus(robot_name=cfg.own_name)
        # the sensor processors, flushed every tick (:819-824)
        self.gps_processor = GpsProcessor(cfg.gps)
        self.imu_processor = ImuProcessor(cfg.imu)
        self.floor_processor = FloorCoeffsProcessor(cfg.floor_coeffs)
        x, y, z, yaw, pitch, roll = cfg.init_pose
        q = se3np.rpy_to_quat(roll, pitch, yaw)
        self.init_pose = np.concatenate(
            [np.asarray([x, y, z], np.float32), q]).astype(np.float32)
        # odom->map transform, set at the first keyframe and re-estimated
        # after every optimization (:864-880)
        self.trans_odom2map = se3np.pose_identity()
        self._init_done = False
        self.tick_stats: List[TickStats] = []

    # ------------------------------------------------------------------
    # front-end entry
    # ------------------------------------------------------------------
    def process_scan(self, stamp: float, odom_pose: np.ndarray,
                     cloud: PointCloud, source_covs=None) -> PoseWithName:
        """Keyframe admission and enqueue.

        `odom_pose` is the scan-matching odometry estimate (odom frame);
        `cloud` the prefiltered scan in the base frame, on the device.
        Returns the PoseWithName odom broadcast (sent every scan,
        :450-455).

        `source_covs` ((P, 3, 3) tensor): this scan's GICP covariances,
        when the front end computed them over the same cloud with
        covariance-compatible settings (ops.registration.
        covariance_compatible; odometry_fused emits them as
        OdomStepOut.covs). They become the keyframe's pair-program cloud,
        so the tick runs no covariance pass for it.
        """
        accepted = self.keyframe_updater.update(odom_pose)
        accum = self.keyframe_updater.accum_distance
        broadcast = PoseWithName(robot_name=self.own_name, stamp=stamp,
                                 pose=np.asarray(odom_pose, np.float32),
                                 accum_dist=accum)
        if accepted:
            kf = self.db.add_odom_keyframe(stamp, odom_pose, accum, cloud)
            if source_covs is not None:
                kf.gicp = GICPCloud(cloud.points, cloud.mask, source_covs)
        return broadcast

    # ------------------------------------------------------------------
    # the main loop (graph_update_interval timer)
    # ------------------------------------------------------------------
    def optimization_tick(self, now: float = 0.0) -> Optional[TickStats]:
        """optimization_timer_callback (:802): flush -> loops -> optimize.
        Returns None when there was nothing to do."""
        pre = self._tick_begin(now)
        if pre is None:
            return None
        stats = _loops_and_solve(self.db, self.loop_detector, pre,
                                 [self.status])
        self._tick_post(stats)
        return stats

    def _tick_begin(self, now: float):
        """Init, queue flushes and the deferred-edge fitness requests.
        Returns (stats, deferred_edges, edge_requests), or None when the
        tick has nothing to do."""
        stats = TickStats()
        if not self._init_done and self.db.keyframe_queue:
            # set_init_pose (:458): odom2map starts at the configured pose
            self.trans_odom2map = self.init_pose.copy()
            self._init_done = True
            self.status.initialized = True

        pending_edges = self.db.flush_keyframe_queue(self.trans_odom2map,
                                                     defer_info=True)
        flushed = bool(pending_edges)
        flushed |= self.db.flush_static_keyframe_queue()
        flushed |= self.db.flush_graph_queue()
        flushed |= self.db.flush_loaded_graph()
        flushed |= _flush_processors(
            self.db, (self.floor_processor, self.gps_processor,
                      self.imu_processor), self.db.own_keyframes())
        if not flushed and not self.db.new_keyframes:
            return None
        # covariances of the new keyframes that came without them
        self.loop_detector.runner.prefetch_batch(self.db.new_keyframes)

        # odometry edges whose information needs a fitness pass ride in
        # the loop detector's batch
        deferred = [e for e in pending_edges if e.edge_id is None]
        edge_reqs = tuple(PairRequest(
            target=self.db.uuid_keyframe_map[e.from_uuid],
            source=self.db.uuid_keyframe_map[e.to_uuid],
            init_pose=e.relative_pose) for e in deferred)
        return stats, deferred, edge_reqs

    def _tick_post(self, stats: TickStats) -> None:
        """After the solve: odom2map re-estimation and the trajectory
        snapshot."""
        # re-estimate odom2map from our latest keyframe (:864-880)
        prev = self.db.prev_robot_keyframe
        if prev is not None and prev.node_id is not None:
            est = prev.estimate(self.db.graph)
            self.trans_odom2map = se3np.pose_compose(
                est, se3np.pose_inverse(prev.odom))
        # per-tick trajectory snapshot (:896 -> graph_database.cpp:599)
        self.db.save_keyframe_poses()
        self.tick_stats.append(stats)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------
    def trajectory(self) -> np.ndarray:
        """(K, 7) optimized keyframe poses of our own chain, in stamp
        order."""
        own = sorted(self.db.own_keyframes(), key=lambda k: k.stamp)
        if not own:
            return np.zeros((0, 7), np.float32)
        return np.stack([k.estimate(self.db.graph) for k in own])

    def map_pose(self, odom_pose: np.ndarray) -> np.ndarray:
        """Current map-frame pose of the robot given its odometry pose."""
        return se3np.pose_compose(self.trans_odom2map, odom_pose)

    def slam_pose_broadcast(self, stamp: float) -> Optional[PoseWithName]:
        """The latest keyframe's optimized pose, or None before the first
        flush."""
        prev = self.db.prev_robot_keyframe
        if prev is None or prev.node_id is None:
            return None
        return PoseWithName(robot_name=self.own_name, stamp=stamp,
                            pose=prev.estimate(self.db.graph),
                            accum_dist=prev.accum_distance)

    def generate_map(self, skip_first_cloud: bool = True) -> np.ndarray:
        """The map over every keyframe at its optimized pose, (M, 3)."""
        return self.map_generator.from_store(self.db, skip_first_cloud)

    def save_map(self, file_path: str, resolution: Optional[float] = None,
                 min_points_per_voxel: Optional[int] = None,
                 distance_far_thresh: Optional[float] = None,
                 skip_first_cloud: bool = True) -> int:
        """SaveMap (:1078-1098): assemble the map with per-call overrides
        of the generator's parameters and write it as a binary PCD.
        Returns the number of points written; with no keyframe yet it
        writes no file."""
        if not (self.db.keyframes or self.db.new_keyframes):
            return 0
        cfg = self.cfg
        gen = MapCloudGenerator(
            resolution or cfg.map_cloud_resolution,
            min_points_per_voxel or cfg.map_cloud_min_points_per_voxel,
            distance_far_thresh or cfg.map_cloud_distance_far_thresh)
        pts = gen.from_store(self.db, skip_first_cloud)
        save_pcd(file_path, pts)
        return len(pts)
