"""Shared-graph co-hosting: R robots on one card, one pose graph, one tick.

Counterpart of the JAX package's models/shared_graph.py. The reference
runs one SLAM process per robot and reconciles their graphs through the
delta-graph exchange (apps/mrg_slam_component.cpp:517-643). Robots
co-hosted on one card need none of that: one GraphDatabase holds every
robot's keyframe chain (each with its own anchor, odometry edges and
keyframe counter), one loop detector matches each new keyframe once
against the union store, so inter-robot loops come from the same search
as the others (the same- and other-robot accum-distance gates still
apply, through each robot's own `slam_uuid`), and one LM solve per tick
optimizes the joint graph. Each robot keeps its own view: the keyframe
admission gate, its odom->map transform and its status.

Each view owns its floor, GPS and IMU processors, which a tick flushes
per robot over that robot's keyframes (the JAX package's
shared_graph.py:222-230).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..ops.cloud import PointCloud, pad_invalid
from ..ops.covariance import GICPCloud
from ..parallel.messages import PoseWithName, SlamStatus
from ..runtime import DeviceLike
from ..utils import se3np
from .backend import (MrgSlam, TickStats, _flush_processors,
                      _loops_and_solve, _remove_points_near)
from .graph_database import GraphDatabase
from .keyframe import new_uuid
from .keyframe_updater import KeyframeUpdater
from .loop_detector import LoopDetector
from .map_cloud import MapCloudGenerator
from .pair_runner import PairRequest
from .processors import FloorCoeffsProcessor, GpsProcessor, ImuProcessor


class _RobotView:
    """One robot's front-end state over the shared store."""

    def __init__(self, name: str, cfg: SlamConfig,
                 init_pose: Tuple[float, ...]):
        self.name = name
        self.slam_uuid = new_uuid()
        self.keyframe_updater = KeyframeUpdater(cfg.keyframe_delta_trans,
                                                cfg.keyframe_delta_angle)
        x, y, z, yaw, pitch, roll = init_pose
        q = se3np.rpy_to_quat(roll, pitch, yaw)
        self.init_pose = np.concatenate(
            [np.asarray([x, y, z], np.float32), q]).astype(np.float32)
        self.trans_odom2map = se3np.pose_identity()
        self.init_done = False
        self.status = SlamStatus(robot_name=name)
        self.last_odom_pose: Optional[np.ndarray] = None
        self.gps_processor = GpsProcessor(cfg.gps)
        self.imu_processor = ImuProcessor(cfg.imu)
        self.floor_processor = FloorCoeffsProcessor(cfg.floor_coeffs)


class SharedGraphSlam:
    """R co-hosted robots over one shared pose graph (module doc), on the
    card unless `device` says otherwise.

    `cfg.own_name` is the group's primary identity (result directories);
    `robot_names` lists every hosted robot. `init_poses` maps robot name
    -> (x, y, z, yaw, pitch, roll) start pose, `cfg.init_pose` for a robot
    it does not list.
    """

    def __init__(self, cfg: SlamConfig, robot_names: Sequence[str],
                 init_poses: Optional[Dict[str, Tuple[float, ...]]] = None,
                 device: DeviceLike = None):
        if not robot_names:
            raise ValueError("need at least one robot")
        self.cfg = cfg
        self.db = GraphDatabase(cfg, device=device)
        self.loop_detector = LoopDetector(cfg.loop, cfg.registration)
        self.map_generator = MapCloudGenerator.of_config(cfg)
        init_poses = init_poses or {}
        self.views: Dict[str, _RobotView] = {
            name: _RobotView(name, cfg, init_poses.get(name, cfg.init_pose))
            for name in robot_names}
        self.tick_stats: List[TickStats] = []

    # ------------------------------------------------------------------
    # front-end entry (per robot)
    # ------------------------------------------------------------------
    def process_scan(self, robot_name: str, stamp: float,
                     odom_pose: np.ndarray, cloud: PointCloud,
                     source_covs=None) -> PoseWithName:
        """Keyframe admission for one robot's scan (cloud_callback,
        mrg_slam_component.cpp:358). Other-robot point removal takes the
        co-hosted views' positions directly.

        `source_covs` ((P, 3, 3) tensor): the front end's GICP
        covariances over the same cloud, as MrgSlam.process_scan takes
        them; dropped when point removal changed the cloud (the tick's
        prefetch then computes the keyframe's own)."""
        view = self.views[robot_name]
        view.last_odom_pose = np.asarray(odom_pose, np.float32)
        accepted = view.keyframe_updater.update(odom_pose)
        accum = view.keyframe_updater.accum_distance
        broadcast = PoseWithName(robot_name=robot_name, stamp=stamp,
                                 pose=np.asarray(odom_pose, np.float32),
                                 accum_dist=accum)
        if not accepted:
            return broadcast
        cloud2 = self._remove_other_robot_points(view, odom_pose, cloud)
        kf = self.db.add_odom_keyframe(stamp, odom_pose, accum, cloud2,
                                       robot_name=robot_name,
                                       slam_uuid=view.slam_uuid)
        if source_covs is not None and cloud2 is cloud:
            kf.gicp = GICPCloud(cloud.points, cloud.mask, source_covs)
        return broadcast

    def _remove_other_robot_points(self, view: _RobotView,
                                   odom_pose: np.ndarray,
                                   cloud: PointCloud) -> PointCloud:
        """mrg_slam_component.cpp:375-443 with every other initialized
        view's current map-frame position, up to MAX_OTHER_ROBOTS of
        them; the cloud itself when the radius is 0 or no other robot is
        placed yet."""
        r = self.cfg.robot_remove_points_radius
        if r <= 0:
            return cloud
        n_max = MrgSlam.MAX_OTHER_ROBOTS
        centers = np.zeros((n_max, 3), np.float32)
        valid = np.zeros(n_max, bool)
        map2base = se3np.pose_inverse(
            se3np.pose_compose(view.trans_odom2map, odom_pose))
        i = 0
        for other in self.views.values():
            if (other is view or other.last_odom_pose is None
                    or not other.init_done or i >= n_max):
                continue
            other_map = se3np.pose_compose(other.trans_odom2map,
                                           other.last_odom_pose)
            centers[i] = se3np.pose_apply(map2base, other_map[:3])
            valid[i] = True
            i += 1
        if not valid.any():
            return cloud
        dev = cloud.points.device
        mask = _remove_points_near(cloud.points, cloud.mask,
                                   torch.from_numpy(centers).to(dev),
                                   torch.from_numpy(valid).to(dev), r)
        return PointCloud(pad_invalid(cloud.points, mask), mask)

    # ------------------------------------------------------------------
    # the main loop: one tick for the whole fleet
    # ------------------------------------------------------------------
    def optimization_tick(self, now: float = 0.0) -> Optional[TickStats]:
        """optimization_timer_callback (:802) once for every hosted robot:
        flush -> loops -> optimize. Returns None when there was nothing to
        do."""
        pre = self._tick_begin(now)
        if pre is None:
            return None
        stats = _loops_and_solve(self.db, self.loop_detector, pre,
                                 [v.status for v in self.views.values()])
        self._tick_post(stats)
        return stats

    def _tick_begin(self, now: float):
        """Per-robot init, the flushes and the deferred-edge fitness
        requests -> (stats, deferred edges, requests), or None."""
        queued = {k.robot_name for k in self.db.keyframe_queue}
        for view in self.views.values():
            if not view.init_done and view.name in queued:
                # set_init_pose (:458), per robot, once its first
                # keyframe is queued
                view.trans_odom2map = view.init_pose.copy()
                view.init_done = True
                view.status.initialized = True
        odom2maps = {n: v.trans_odom2map for n, v in self.views.items()}
        pending_edges = self.db.flush_keyframe_queue(odom2maps,
                                                     defer_info=True)
        flushed = bool(pending_edges)
        flushed |= self.db.flush_static_keyframe_queue()
        flushed |= self.db.flush_graph_queue()
        flushed |= self.db.flush_loaded_graph(
            self.loop_detector.loop_manager)
        by_robot: Dict[str, List] = {}
        for k in self.db.keyframes + self.db.new_keyframes:
            if k.odom_counter >= 0:
                by_robot.setdefault(k.robot_name, []).append(k)
        for name, view in self.views.items():
            flushed |= _flush_processors(
                self.db, (view.floor_processor, view.gps_processor,
                          view.imu_processor), by_robot.get(name, []))
        if not flushed and not self.db.new_keyframes:
            return None
        self.loop_detector.runner.prefetch_batch(self.db.new_keyframes)
        deferred = [e for e in pending_edges if e.edge_id is None]
        edge_reqs = tuple(PairRequest(
            target=self.db.uuid_keyframe_map[e.from_uuid],
            source=self.db.uuid_keyframe_map[e.to_uuid],
            init_pose=e.relative_pose) for e in deferred)
        return TickStats(), deferred, edge_reqs

    def _tick_post(self, stats: TickStats) -> None:
        """Re-estimate every robot's odom->map from its chain's latest
        keyframe (:864-880) and snapshot the trajectory."""
        for name, view in self.views.items():
            prev = self.db.prev_keyframe_of(name)
            if prev is None or prev.node_id is None:
                continue
            est = prev.estimate(self.db.graph)
            view.trans_odom2map = se3np.pose_compose(
                est, se3np.pose_inverse(prev.odom))
        self.db.save_keyframe_poses()
        self.tick_stats.append(stats)

    # ------------------------------------------------------------------
    # outputs (per robot)
    # ------------------------------------------------------------------
    def robot_keyframes(self, robot_name: str) -> List:
        return [k for k in self.db.keyframes + self.db.new_keyframes
                if k.robot_name == robot_name and k.odom_counter >= 0]

    def trajectory(self, robot_name: str) -> np.ndarray:
        """(K, 7) optimized poses of one robot's chain, in stamp order."""
        own = sorted(self.robot_keyframes(robot_name),
                     key=lambda k: k.stamp)
        if not own:
            return np.zeros((0, 7), np.float32)
        return np.stack([k.estimate(self.db.graph) for k in own])

    def slam_pose_broadcast(self, robot_name: str,
                            stamp: float) -> Optional[PoseWithName]:
        prev = self.db.prev_keyframe_of(robot_name)
        if prev is None or prev.node_id is None:
            return None
        return PoseWithName(robot_name=robot_name, stamp=stamp,
                            pose=prev.estimate(self.db.graph),
                            accum_dist=prev.accum_distance)

    def map_pose(self, robot_name: str, odom_pose: np.ndarray) -> np.ndarray:
        return se3np.pose_compose(self.views[robot_name].trans_odom2map,
                                  odom_pose)

    def generate_map(self, skip_first_cloud: bool = True) -> np.ndarray:
        """One joint map over every robot's keyframes, (M, 3)."""
        return self.map_generator.from_store(self.db, skip_first_cloud)
