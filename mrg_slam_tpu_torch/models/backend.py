"""The SLAM back end: keyframe admission, loop closure, pose-graph
optimization and the multi-robot graph exchange (MrgSlamComponent
without ROS).

Counterpart of the JAX package's models/backend.py.
apps/mrg_slam_component.cpp's timers and callbacks become methods:

- `process_scan`           <- cloud_callback (:358)
- `optimization_tick`      <- optimization_timer_callback (:802)
- `on_slam_pose_broadcast` <- slam_pose_broadcast_callback (:517)
- `on_odom_broadcast`      <- odom_broadcast_callback (:649)
- `handle_publish_graph`   <- publish_graph_service (:1153)
- `slam_pose_broadcast`    <- the slam pose broadcast timer
- `generate_map`           <- map_points_publish_timer (:764)
- `save_map`               <- save_map_service (:1078-1098)

A tick runs its device work in two programs: the pair program (every
odometry edge's fitness, every loop candidate's registration and the
consistency checks, models/pair_runner.py) and the dense LM solve with
per-tick marginals (graph/solve.py). Its host reads: one per Gauss-Newton
sweep and one per pair bucket, one per LM iteration, and one packed read
of the solve's poses, chi2 and marginals. The tick's stages
(`_tick_begin`, `_pair_stage`, `_tick_insert`, `_solve_stage`,
`_tick_post`) are also driven by models/coordinator.SharedTick, which
runs several robots' pair rows in one program and their solves in one
batched LM.

The exchange works on the host: a delta graph carries each keyframe's
estimate from the host staging buffers and its cloud as the tensors on
the card it already is (zero-copy in one process), the proximity tests
use host estimates, and the receiver merges the graph in its next tick
(models/graph_database.flush_graph_queue). The floor, GPS and IMU
processors (models/processors.py) are flushed in each tick after the
queues, in the JAX package's order (backend.py:241-244).
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..io.pcd import save_pcd
from ..ops.cloud import PointCloud, pad_invalid
from ..ops.covariance import GICPCloud
from ..ops.stats_kernel import radius_sq
from ..parallel.messages import (EdgeMsg, GraphMsg, KeyFrameMsg,
                                 PoseWithName, PublishGraphRequest,
                                 SlamStatus)
from ..runtime import DeviceLike
from ..utils import profiling, se3np
from .graph_database import GraphDatabase
from .keyframe import EDGE_ANCHOR
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
    # of them, the LM iterations that ran graph/lm_dense.py's kernels
    lm_fused_iterations: int = 0
    lm_ms: float = 0.0         # snapshot upload and LM (graph/builder.py)
    marginals_ms: float = 0.0  # marginals and the solve's packed read
    # (rows, GN iterations of the slowest row) of each pair-program bucket
    pair_buckets: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


def _flush_processors(db: GraphDatabase, procs, keyframes) -> bool:
    """The floor, GPS and IMU processors' flushes into the graph, in the
    JAX package's order; whether any added an edge."""
    flushed = False
    for proc in procs:
        flushed |= proc.flush(db, keyframes)
    return flushed


def _set_flag(statuses, name: str, value: bool) -> None:
    for st in statuses:
        setattr(st, name, value)


def _tick_insert(db: GraphDatabase, stats: TickStats, deferred,
                 edge_results, loops) -> None:
    """The tick's deferred odometry edges, weighted by their fitness, and
    its accepted loops into the graph."""
    with profiling.span("loops.resolve"):
        stats.num_loops = len(loops)
        db.finalize_edges(deferred, [r.fitness_inf for r in edge_results])
        db.insert_loops(loops)


def _pair_stage(db: GraphDatabase, loop_detector: LoopDetector, pre,
                statuses) -> TickStats:
    """A tick's pair program after its flushes (`pre` = (stats, deferred
    edges, their fitness requests) from a `_tick_begin`): loop detection
    with the edges' fitness rows, then the new edges and accepted loops
    into the graph, the statuses flagged meanwhile."""
    stats, deferred, edge_reqs = pre
    _set_flag(statuses, "in_loop_closure", True)
    runner = loop_detector.runner
    runner.buckets.clear()
    t0 = time.perf_counter()
    loops, edge_results = loop_detector.detect(db, edge_reqs)
    stats.loop_closure_us = (time.perf_counter() - t0) * 1e6
    stats.pair_buckets = list(runner.buckets)
    _set_flag(statuses, "in_loop_closure", False)
    _tick_insert(db, stats, deferred, edge_results, loops)
    return stats


def _solve_stats(graph, stats: TickStats) -> None:
    """The solve's chi2, iterations and walls into the tick's stats."""
    stats.chi2_before = graph.chi2_initial
    stats.chi2_after = graph.chi2_final
    stats.iterations = graph.last_iterations
    stats.lm_fused_iterations = graph.last_fused_iterations
    stats.lm_ms = graph.last_lm_ms
    stats.marginals_ms = graph.last_marginals_ms


def _solve_stage(db: GraphDatabase, stats: TickStats, statuses) -> None:
    """The tick's LM solve, the statuses flagged meanwhile."""
    _set_flag(statuses, "in_optimization", True)
    t0 = time.perf_counter()
    db.optimize()
    stats.optimization_us = (time.perf_counter() - t0) * 1e6
    _set_flag(statuses, "in_optimization", False)
    _solve_stats(db.graph, stats)


def _loops_and_solve(db: GraphDatabase, loop_detector: LoopDetector,
                     pre, statuses) -> TickStats:
    """A whole tick after its flushes: `_pair_stage`, then
    `_solve_stage`."""
    stats = _pair_stage(db, loop_detector, pre, statuses)
    _solve_stage(db, stats, statuses)
    return stats


class MrgSlam:
    """One robot's SLAM back end, on the card unless `device` says
    otherwise."""

    MAX_OTHER_ROBOTS = 8  # point-removal centers per scan
    MAX_STORED_SLAM_POSES = 1024  # PATH_PROXIMITY backlog cap per robot

    def __init__(self, cfg: SlamConfig, device: DeviceLike = None):
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

        # the other robots: their latest odom broadcasts, their odom->map
        # transforms (re-estimated from their latest merged keyframe after
        # every optimization, :864-880), their current positions in this
        # robot's map frame (known once their graph was merged,
        # :660-683), their slam-pose broadcasts since the last exchange
        # (PATH_PROXIMITY), and the accum distance and time of the last
        # exchange with each
        self.others_odom_poses: Dict[str, PoseWithName] = {}
        self.others_odom2map: Dict[str, np.ndarray] = {}
        self.others_map_poses: Dict[str, np.ndarray] = {}
        self.others_slam_poses: Dict[str, List[PoseWithName]] = {}
        self.others_last_accum_dist: Dict[str, float] = {}
        self.others_last_exchange_time: Dict[str, float] = {}
        self.received_graph_bytes: List[int] = []
        self.sent_graph_bytes: List[int] = []
        self.tick_stats: List[TickStats] = []
        self._tick_executor: Optional[ThreadPoolExecutor] = None

    # ------------------------------------------------------------------
    # front-end entry
    # ------------------------------------------------------------------
    def process_scan(self, stamp: float, odom_pose: np.ndarray,
                     cloud: PointCloud, source_covs=None) -> PoseWithName:
        """Keyframe admission, other-robot point removal and enqueue.

        `odom_pose` is the scan-matching odometry estimate (odom frame);
        `cloud` the prefiltered scan in the base frame, on the device.
        Returns the PoseWithName odom broadcast (sent every scan,
        :450-455).

        `source_covs` ((P, 3, 3) tensor): this scan's GICP covariances,
        when the front end computed them over the same cloud with
        covariance-compatible settings (ops.registration.
        covariance_compatible; odometry_fused emits them as
        OdomStepOut.covs). They become the keyframe's pair-program cloud,
        so the tick runs no covariance pass for it; when point removal
        changed the cloud they would be stale, and the tick computes the
        keyframe's own.
        """
        accepted = self.keyframe_updater.update(odom_pose)
        accum = self.keyframe_updater.accum_distance
        broadcast = PoseWithName(robot_name=self.own_name, stamp=stamp,
                                 pose=np.asarray(odom_pose, np.float32),
                                 accum_dist=accum)
        if not accepted:
            return broadcast
        cloud2 = self._remove_other_robot_points(odom_pose, cloud)
        kf = self.db.add_odom_keyframe(stamp, odom_pose, accum, cloud2)
        if source_covs is not None and cloud2 is cloud:
            kf.gicp = GICPCloud(cloud.points, cloud.mask, source_covs)
        return broadcast

    def _remove_other_robot_points(self, odom_pose: np.ndarray,
                                   cloud: PointCloud) -> PointCloud:
        """The cloud without the points near other robots
        (mrg_slam_component.cpp:375-443), up to MAX_OTHER_ROBOTS of them;
        the cloud itself when the radius is 0 or no other robot is placed
        yet. A robot is placed in this robot's map frame once its graph
        was merged (`others_map_poses`, :660-683), as the reference gates
        others_odom_poses_ on others_odom2map_."""
        r = self.cfg.robot_remove_points_radius
        if r <= 0:
            return cloud
        n_max = self.MAX_OTHER_ROBOTS
        # the centers in this scan's base frame, and a validity column:
        # one upload
        cv = np.zeros((n_max, 4), np.float32)
        map2base = se3np.pose_inverse(
            se3np.pose_compose(self.trans_odom2map, odom_pose))
        i = 0
        for name, map_pose in self.others_map_poses.items():
            if name == self.own_name or i >= n_max:
                continue
            cv[i, :3] = se3np.pose_apply(map2base, map_pose[:3])
            cv[i, 3] = 1.0
            i += 1
        if not i:
            return cloud
        cv = torch.from_numpy(cv).to(cloud.points.device)
        mask = _remove_points_near(cloud.points, cloud.mask, cv[:, :3],
                                   cv[:, 3] > 0, r)
        return PointCloud(pad_invalid(cloud.points, mask), mask)

    # ------------------------------------------------------------------
    # the main loop (graph_update_interval timer)
    # ------------------------------------------------------------------
    def optimization_tick(self, now: float = 0.0) -> Optional[TickStats]:
        """optimization_timer_callback (:802): flush -> loops -> optimize.
        Returns None when there was nothing to do."""
        with profiling.request("tick"):
            pre = self._tick_begin(now)
            if pre is None:
                return None
            stats = _loops_and_solve(self.db, self.loop_detector, pre,
                                     [self.status])
            self._tick_post(stats)
        return stats

    def optimization_tick_async(self, now: float = 0.0) -> Future:
        """The tick on a worker thread while scans keep coming in: the
        reference's optimization timer (mrg_slam_component.cpp:802) fires
        beside its streaming cloud callback. Scan ingestion only appends
        to the keyframe queue under `GraphDatabase.queue_lock`, so the
        tick's flush and the front end never race; a keyframe admitted
        while a tick runs goes to the next one. Both threads launch on
        the same default stream, so their device work runs one after the
        other.

        Returns a concurrent.futures.Future; the one worker runs the ticks
        one at a time. The replay harness calls the synchronous
        `optimization_tick`, so a run repeats."""
        if self._tick_executor is None:
            self._tick_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"tick-{self.own_name}")
        return self._tick_executor.submit(self.optimization_tick, now)

    def _tick_begin(self, now: float):
        """Init, queue flushes and the deferred-edge fitness requests.
        Returns (stats, deferred_edges, edge_requests), or None when the
        tick has nothing to do."""
        with profiling.span("tick.flush"):
            if not self._init_done and self.db.keyframe_queue:
                # set_init_pose (:458): odom2map starts at the configured
                # pose
                self.trans_odom2map = self.init_pose.copy()
                self._init_done = True
                self.status.initialized = True

            pending_edges = self.db.flush_keyframe_queue(
                self.trans_odom2map, defer_info=True)
            flushed = bool(pending_edges)
            flushed |= self.db.flush_static_keyframe_queue()
            flushed |= self.db.flush_graph_queue(
                self.loop_detector.loop_manager)
            flushed |= self.db.flush_loaded_graph(
                self.loop_detector.loop_manager)
            flushed |= _flush_processors(
                self.db, (self.floor_processor, self.gps_processor,
                          self.imu_processor), self.db.own_keyframes())
        if not flushed and not self.db.new_keyframes:
            return None
        # covariances of the new keyframes (own and merged) that came
        # without them
        with profiling.span("tick.prefetch"):
            self.loop_detector.runner.prefetch_batch(self.db.new_keyframes)

        # odometry edges whose information needs a fitness pass ride in
        # the loop detector's batch
        deferred = [e for e in pending_edges if e.edge_id is None]
        edge_reqs = tuple(PairRequest(
            target=self.db.uuid_keyframe_map[e.from_uuid],
            source=self.db.uuid_keyframe_map[e.to_uuid],
            init_pose=e.relative_pose) for e in deferred)
        return TickStats(), deferred, edge_reqs

    def _tick_post(self, stats: TickStats) -> None:
        """After the solve: this robot's odom->map and every other
        robot's re-estimated, and the trajectory snapshot."""
        with profiling.span("tick.post"):
            # this robot's odom2map from its latest keyframe (:864-880)
            prev = self.db.prev_robot_keyframe
            if prev is not None and prev.node_id is not None:
                est = prev.estimate(self.db.graph)
                self.trans_odom2map = se3np.pose_compose(
                    est, se3np.pose_inverse(prev.odom))
            # each other robot's from its latest merged keyframe (:871-880),
            # and its position in this robot's map frame with it
            for name, (kf_uuid, kf_odom) in self.db.others_last_kf.items():
                kf = self.db.uuid_keyframe_map.get(kf_uuid)
                if kf is None or kf.node_id is None:
                    continue
                o2m = se3np.pose_compose(kf.estimate(self.db.graph),
                                         se3np.pose_inverse(kf_odom))
                self.others_odom2map[name] = o2m
                odom_msg = self.others_odom_poses.get(name)
                if odom_msg is not None:
                    self.others_map_poses[name] = se3np.pose_compose(
                        o2m, odom_msg.pose)
            # per-tick trajectory snapshot (:896 -> graph_database.cpp:599)
            self.db.save_keyframe_poses()
            self.tick_stats.append(stats)

    # ------------------------------------------------------------------
    # the graph exchange
    # ------------------------------------------------------------------
    def on_odom_broadcast(self, msg: PoseWithName) -> None:
        """Track another robot's current pose (:649) for point removal.
        The pose lives in the sender's odom frame; it is placed in this
        robot's map frame through the sender's odom->map transform once
        that is known (:660-683)."""
        if msg.robot_name == self.own_name:
            return
        self.others_odom_poses[msg.robot_name] = msg
        o2m = self.others_odom2map.get(msg.robot_name)
        if o2m is not None:
            self.others_map_poses[msg.robot_name] = se3np.pose_compose(
                o2m, msg.pose)

    def others_poses_in_map(self, stamp: float) -> List[PoseWithName]:
        """PoseWithNameArray: every placed other robot's current pose in
        this robot's map frame (published per odom broadcast,
        :655-683)."""
        return [PoseWithName(robot_name=n, stamp=stamp, pose=p.copy(),
                             accum_dist=self.others_odom_poses[n].accum_dist
                             if n in self.others_odom_poses else 0.0)
                for n, p in self.others_map_poses.items()]

    def on_slam_pose_broadcast(
            self, msg: PoseWithName, now: float,
            request_fn: Callable[[str, PublishGraphRequest],
                                 Optional[GraphMsg]]) -> bool:
        """Whether to pull a delta graph from the sender, and the pull
        (:517-643). `request_fn(robot_name, request)` makes the transport
        call and returns the GraphMsg (None on a timeout). Returns True
        when a graph was received; it is merged in the next tick.

        The accum-distance and time gates come first; then, in
        CURRENT_PROXIMITY mode, the sender must be within
        `graph_request_max_robot_dist` (xy) of this robot's latest
        keyframe, in PATH_PROXIMITY mode any of its broadcasts since the
        last exchange within that distance of any keyframe in the graph.
        The estimates are the host staging buffers': nothing here reads
        the card."""
        if (msg.robot_name == self.own_name
                or self.db.prev_robot_keyframe is None
                or msg.robot_name not in self.cfg.multi_robot_names):
            return False
        name = msg.robot_name
        last_accum = self.others_last_accum_dist.get(name, -1.0)
        stored = self.others_slam_poses.setdefault(name, [])
        stored.append(msg)
        # bound PATH_PROXIMITY's backlog: a long run without overlap
        # would keep every broadcast until a trigger clears them
        if len(stored) > self.MAX_STORED_SLAM_POSES:
            del stored[: len(stored) - self.MAX_STORED_SLAM_POSES]
        ex = self.cfg.exchange
        if (last_accum >= 0 and abs(msg.accum_dist - last_accum)
                < ex.graph_request_min_accum_dist):
            return False
        last_t = self.others_last_exchange_time.get(name, -1.0)
        if last_t >= 0 and now - last_t < ex.graph_request_min_time_delay:
            return False

        max_d2 = ex.graph_request_max_robot_dist ** 2
        request = False
        if ex.graph_exchange_mode == "CURRENT_PROXIMITY":
            own = self.db.prev_robot_keyframe.estimate(self.db.graph)[:2]
            request = float(np.sum((own - msg.pose[:2]) ** 2)) < max_d2
        elif ex.graph_exchange_mode == "PATH_PROXIMITY":
            own_xy = (np.asarray([k.estimate(self.db.graph)[:2]
                                  for k in self.db.keyframes])
                      if self.db.keyframes else np.zeros((0, 2)))
            for other in stored:
                if own_xy.size and float(np.min(np.sum(
                        (own_xy - other.pose[:2]) ** 2, axis=1))) < max_d2:
                    request = True
                    stored.clear()
                    break
        if not request:
            return False

        self.others_last_exchange_time[name] = now
        self.status.in_graph_exchange = True
        graph = request_fn(name, self._graph_request())
        self.status.in_graph_exchange = False
        if graph is None:
            return False
        self.received_graph_bytes.append(graph.nbytes())
        self.db.add_graph_msg(graph)
        self.others_last_accum_dist[name] = msg.accum_dist
        return True

    def _graph_request(self) -> PublishGraphRequest:
        return PublishGraphRequest(
            robot_name=self.own_name,
            processed_keyframe_uuids=set(self.db.uuid_keyframe_map),
            processed_edge_uuids=set(self.db.edge_uuids))

    def handle_publish_graph(self, req: PublishGraphRequest) -> GraphMsg:
        """Serve the delta graph: the keyframes and edges the requester
        has not processed, anchors left out (publish_graph_service,
        :1153-1246). Estimates are copies of the host staging buffers'
        rows; clouds are handed over as they are."""
        kmsgs: List[KeyFrameMsg] = []
        for kf in self.db.keyframes + self.db.new_keyframes:
            if kf.uuid in req.processed_keyframe_uuids or kf.odom_counter < 0:
                continue
            kmsgs.append(KeyFrameMsg(
                robot_name=kf.robot_name, uuid=kf.uuid,
                slam_uuid=kf.slam_uuid, stamp=kf.stamp,
                odom_counter=kf.odom_counter,
                first_keyframe=kf.first_keyframe,
                static_keyframe=kf.static_keyframe,
                accum_distance=kf.accum_distance,
                estimate=np.array(kf.estimate(self.db.graph), np.float32),
                cloud=kf.cloud))
        emsgs = [EdgeMsg(type=e.type, uuid=e.uuid, from_uuid=e.from_uuid,
                         to_uuid=e.to_uuid, relative_pose=e.relative_pose,
                         information=e.information)
                 for e in self.db.edges
                 if e.uuid not in req.processed_edge_uuids
                 and e.type != EDGE_ANCHOR]
        prev = self.db.prev_robot_keyframe
        msg = GraphMsg(
            robot_name=self.own_name,
            latest_keyframe_uuid=prev.uuid if prev else "",
            latest_keyframe_odom=(np.asarray(prev.odom) if prev
                                  else se3np.pose_identity()),
            keyframes=kmsgs, edges=emsgs)
        self.sent_graph_bytes.append(msg.nbytes())
        return msg

    # ------------------------------------------------------------------
    # service equivalents (apps/mrg_slam_component.cpp:184-217)
    # ------------------------------------------------------------------
    def set_init_pose(self, pose7: np.ndarray) -> None:
        """Initial-pose override (the init_pose_topic and init_odom_topic
        paths of :458-515); it takes effect only before the first
        keyframe."""
        if not self._init_done:
            self.init_pose = np.asarray(pose7, np.float32)

    def get_graph_uuids(self) -> Tuple[List[str], List[str]]:
        """GetGraphUuids: every keyframe uuid and every edge uuid."""
        return (list(self.db.uuid_keyframe_map.keys()),
                sorted(self.db.edge_uuids))

    def request_graphs(self, robot_names: List[str], now: float,
                       request_fn: Callable) -> int:
        """RequestGraphs (:1249): pull delta graphs from the named peers
        without the gates (a robot joining late). Returns how many
        answered."""
        n = 0
        for name in robot_names:
            if name == self.own_name:
                continue
            graph = request_fn(name, self._graph_request())
            if graph is not None:
                self.received_graph_bytes.append(graph.nbytes())
                self.db.add_graph_msg(graph)
                self.others_last_exchange_time[name] = now
                n += 1
        return n

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
