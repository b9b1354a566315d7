"""Dataset replay: one or more robots' stacks (prefilter -> scan-matching
odometry -> back end) driven over frame sources, deterministically.

Counterpart of the JAX package's pipeline/replay.py, the no-ROS
equivalent of the reference's python_scripts/. As the reference's kitti
and nebula processors gate playback on SlamStatus
(kitti_multirobot_processor.py:95-99), the optimization tick runs
synchronously every `tick_every` frames, so a run repeats. Frame sources
are iterables of (stamp, (N, 3) numpy scan), such as the synthetic
world's scans. `replay_multirobot` runs several robots in one process
with the graph exchange between them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import EngineConfig
from ..models import odometry_fused as fused
from ..models.backend import MrgSlam
from ..models.floor_detection import FloorDetection
from ..models.odometry import ScanMatchingOdometry
from ..models.processors import ImuSample
from ..ops import registration as reg
from ..ops.cloud import PAD_VALUE, PointCloud
from ..ops.prefilter import prefilter
from ..runtime import DeviceLike, resolve_device
from ..utils.metrics import ate_rmse, rpe_rmse
from ..utils.tum import save_tum


class Robot:
    """One robot's full stack: prefilter, odometry, floor detection and
    back end, on the card unless `device` says otherwise. `floor_sampler`
    replaces the floor detector's RANSAC triplet draws
    (models/floor_detection.py)."""

    def __init__(self, cfg: EngineConfig, device: DeviceLike = None,
                 floor_sampler=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._base_tf = (
            torch.from_numpy(cfg.lidar2base.pose7()).to(self.device)
            if cfg.lidar2base.enable_lidar2base_publisher else None)
        self.odometry = ScanMatchingOdometry(cfg.odometry)
        self.slam = MrgSlam(cfg.slam, device=self.device)
        self.floor = (FloorDetection(cfg.floor, sampler=floor_sampler)
                      if cfg.floor.enable_floor_detection else None)
        self.est_poses: List[np.ndarray] = []
        self.stamps: List[float] = []
        self._ang_vel: Optional[np.ndarray] = None

    def add_imu(self, stamp: float, ang_vel, acc, quat) -> None:
        """Feed an IMU sample: its angular velocity deskews the scans that
        follow (prefiltering_component.cpp:231), and the sample queues for
        the orientation and gravity prior edges
        (models/processors.ImuProcessor)."""
        self._ang_vel = np.asarray(ang_vel, np.float32)
        self.slam.imu_processor.add_sample(ImuSample(
            stamp=stamp, quat=np.asarray(quat, np.float32),
            acc=np.asarray(acc, np.float32)))

    def step(self, stamp: float, scan: np.ndarray):
        """One scan through the stack -> (OdometryOutput, the back end's
        odom broadcast)."""
        pc = PointCloud.from_array(
            scan, capacity=self.cfg.prefilter.capacity_raw_points,
            device=self.device)
        ang_vel = frac = None
        if self.cfg.prefilter.enable_deskewing and self._ang_vel is not None:
            # no per-point stamps in KITTI bins or synthetic scans: a
            # uniform sweep over the scan period (rotating LiDAR)
            frac = torch.linspace(0.0, 1.0, pc.capacity, device=self.device)
            ang_vel = torch.from_numpy(self._ang_vel).to(self.device)
        filtered = prefilter(pc, self.cfg.prefilter,
                             base_transform=self._base_tf, ang_vel=ang_vel,
                             point_time_frac=frac)
        if self.floor is not None:
            fc = self.floor.detect(filtered, stamp)
            if fc is not None:
                self.slam.floor_processor.add_coeffs(fc)
        out = self.odometry.step(filtered, stamp)
        broadcast = self.slam.process_scan(stamp, out.pose, filtered)
        self.est_poses.append(self.slam.map_pose(out.pose))
        self.stamps.append(stamp)
        return out, broadcast


@dataclasses.dataclass
class ReplayResult:
    trajectory: np.ndarray           # (N, 7) per-frame map-frame poses
    stamps: np.ndarray
    keyframe_trajectory: np.ndarray  # (K, 7) optimized keyframes
    ate: Optional[float] = None
    rpe: Optional[float] = None
    wall_s: float = 0.0
    frames_per_s: float = 0.0
    num_loops: int = 0


def _result(robot: Robot, n: int, wall: float, gt_xyz: Optional[np.ndarray],
            tum_path: Optional[str]) -> ReplayResult:
    traj = (np.stack(robot.est_poses) if robot.est_poses
            else np.zeros((0, 7), np.float32))
    result = ReplayResult(
        trajectory=traj, stamps=np.asarray(robot.stamps),
        keyframe_trajectory=robot.slam.trajectory(),
        wall_s=wall, frames_per_s=n / max(wall, 1e-9),
        num_loops=sum(1 for e in robot.slam.db.edges if e.type == "loop"))
    if gt_xyz is not None and len(traj):
        m = min(len(traj), len(gt_xyz))
        result.ate = ate_rmse(traj[:m, :3], gt_xyz[:m])
        result.rpe = rpe_rmse(traj[:m, :3], gt_xyz[:m])
    if tum_path:
        save_tum(tum_path, robot.stamps, traj)
    return result


def replay(robot: Robot,
           frames: Iterable[Tuple[float, np.ndarray]],
           tick_every: int = 30,
           gt_xyz: Optional[np.ndarray] = None,
           tum_path: Optional[str] = None,
           progress: Optional[Callable[[int], None]] = None) -> ReplayResult:
    """Single-robot replay, one `Robot.step` a frame, a tick every
    `tick_every` frames (~ graph_update_interval) and one at the end."""
    t0 = time.perf_counter()
    n = 0
    for i, (stamp, scan) in enumerate(frames):
        robot.step(stamp, scan)
        if (i + 1) % tick_every == 0:
            robot.slam.optimization_tick(now=stamp)
        if progress:
            progress(i)
        n += 1
    robot.slam.optimization_tick(now=robot.stamps[-1] if robot.stamps else 0)
    return _result(robot, n, time.perf_counter() - t0, gt_xyz, tum_path)


def replay_fused(robot: Robot,
                 frames: Iterable[Tuple[float, np.ndarray]],
                 tick_every: int = 30,
                 gt_xyz: Optional[np.ndarray] = None,
                 tum_path: Optional[str] = None) -> ReplayResult:
    """Batched single-robot replay: frame blocks of `tick_every` (one
    prefilter over the block, one `odometry_fused.run_batch`, one read of
    the block's poses), then `process_scan` per frame with the front end's
    covariances where they are compatible, and one tick a block.

    A ragged tail block is padded with empty frames, as the JAX package
    pads it (replay.py:178-189); they run keep-last no-ops after the last
    real frame, and only the real frames' outputs are read.

    With floor detection, deskewing or an odometry initial-guess front
    end enabled, this runs the per-frame `replay` instead, as the
    reference does (replay.py:144-152): those features feed the host's
    state into each frame, which a block on the device cannot take. That
    is the reference's own switch between its two paths, on the robot's
    device, not a fall back to another device.
    """
    cfg = robot.cfg
    if (robot.floor is not None or cfg.prefilter.enable_deskewing
            or cfg.odometry.enable_imu_frontend
            or cfg.odometry.enable_robot_odometry_init_guess):
        return replay(robot, frames, tick_every, gt_xyz, tum_path)

    frames = list(frames)
    dev = robot.device
    cap_raw = cfg.prefilter.capacity_raw_points
    covs_ok = reg.covariance_compatible(cfg.odometry.registration,
                                        cfg.slam.registration)
    carry = fused.init_carry(cfg.prefilter.capacity_filtered_points,
                             device=dev)
    t0 = time.perf_counter()
    for s in range(0, len(frames), tick_every):
        chunk = frames[s: s + tick_every]
        raw = np.full((tick_every, cap_raw, 3), PAD_VALUE, np.float32)
        rmask = np.zeros((tick_every, cap_raw), bool)
        stamps = np.zeros(tick_every, np.float32)
        for i, (stamp, scan) in enumerate(chunk):
            m = min(len(scan), cap_raw)
            raw[i, :m] = scan[:m]
            rmask[i, :m] = True
            stamps[i] = stamp
        stamps[len(chunk):] = stamps[len(chunk) - 1]
        block = prefilter(PointCloud(torch.from_numpy(raw).to(dev),
                                     torch.from_numpy(rmask).to(dev)),
                          cfg.prefilter, base_transform=robot._base_tf)
        carry, outs = fused.run_batch(cfg.odometry, carry, block.points,
                                      block.mask,
                                      torch.from_numpy(stamps).to(dev))
        poses = outs.pose.cpu().numpy()  # one read a block
        for i in range(len(chunk)):
            robot.slam.process_scan(
                float(stamps[i]), poses[i],
                PointCloud(block.points[i], block.mask[i]),
                source_covs=outs.covs[i] if covs_ok else None)
            robot.est_poses.append(robot.slam.map_pose(poses[i]))
            robot.stamps.append(float(stamps[i]))
        robot.slam.optimization_tick(now=float(stamps[-1]))
    return _result(robot, len(frames), time.perf_counter() - t0, gt_xyz,
                   tum_path)


def replay_multirobot(robots: Dict[str, Robot],
                      frame_sources: Dict[str, List[Tuple[float,
                                                          np.ndarray]]],
                      tick_every: int = 30,
                      coordinate: bool = True) -> Dict[str, ReplayResult]:
    """In-process multi-robot replay with the full graph exchange.

    Each robot steps one frame a round, in lock step, and its odom
    broadcast goes to every other robot; every `tick_every` rounds every
    robot ticks, then sends its slam-pose broadcast, which may make a
    peer pull its delta graph (the service call is a function call: the
    peer's `handle_publish_graph` answers at once, and the requester
    merges the graph in its next tick).

    With `coordinate` (the default) and more than one robot, the robots
    tick through models/coordinator.SharedTick: one pair program and one
    batched LM for all of them; robots whose registration configs or
    keyframe capacities differ tick one by one. The final ticks stay
    outside the timed window, as the JAX package keeps them
    (replay.py:287-289)."""
    from ..models.coordinator import SharedTick

    t0 = time.perf_counter()
    names = list(robots)
    steps = max(len(v) for v in frame_sources.values())
    s0 = robots[names[0]].cfg.slam
    ticker = None
    if coordinate and len(names) > 1 and all(
            robots[n].cfg.slam.registration == s0.registration
            and (robots[n].cfg.slam.capacity_keyframe_points
                 == s0.capacity_keyframe_points) for n in names[1:]):
        ticker = SharedTick([robots[n].slam for n in names])

    def tick_all(now: float) -> None:
        if ticker is not None:
            ticker.tick_all(now=now)
        else:
            for name in names:
                robots[name].slam.optimization_tick(now=now)

    def request(peer_name: str, req):
        return robots[peer_name].slam.handle_publish_graph(req)

    for i in range(steps):
        for name in names:
            frames = frame_sources[name]
            if i >= len(frames):
                continue
            _, bc = robots[name].step(*frames[i])
            for other in names:
                if other != name:
                    robots[other].slam.on_odom_broadcast(bc)
        if (i + 1) % tick_every == 0:
            tick_all(i * 0.1)
            for name in names:
                sp = robots[name].slam.slam_pose_broadcast(i * 0.1)
                if sp is None:
                    continue
                for other in names:
                    if other != name:
                        robots[other].slam.on_slam_pose_broadcast(
                            sp, now=i * 0.1, request_fn=request)
    wall = time.perf_counter() - t0
    tick_all(steps * 0.1)
    return {name: _result(robots[name], len(robots[name].stamps), wall,
                          None, None) for name in names}


def run_synthetic_demo(n_frames: int = 60, verbose: bool = True,
                       device: DeviceLike = None) -> ReplayResult:
    """A small end-to-end run on the synthetic world (the JAX package's
    demo, replay.py:302-343): 60 frames of 1.1 laps, 8192 raw -> 1024
    filtered points, a tick every 15 frames; on the card unless `device`
    says otherwise."""
    from ..config import (LoopClosureConfig, OptimizerConfig,
                          PrefilterConfig, RegistrationConfig, SlamConfig,
                          ScanMatchingOdometryConfig)
    from ..io.synthetic import SyntheticWorld, circle_trajectory

    reg_cfg = RegistrationConfig(reg_transformation_epsilon=1e-3,
                                 reg_maximum_iterations=32,
                                 reg_correspondence_randomness=10)
    cfg = EngineConfig(
        prefilter=PrefilterConfig(downsample_resolution=0.4,
                                  capacity_raw_points=8192,
                                  capacity_filtered_points=1024,
                                  outlier_removal_method="NONE"),
        odometry=ScanMatchingOdometryConfig(keyframe_delta_translation=2.0,
                                            registration=reg_cfg),
        slam=SlamConfig(own_name="demo", multi_robot_names=("demo",),
                        keyframe_delta_trans=2.0, capacity_keyframes=128,
                        capacity_edges=512, capacity_keyframe_points=1024,
                        registration=reg_cfg,
                        optimizer=OptimizerConfig(
                            solver_backend="dense",
                            g2o_solver_num_iterations=64),
                        loop=dataclasses.replace(LoopClosureConfig(),
                                                 capacity_candidates=4),
                        robot_remove_points_radius=0.0))
    world = SyntheticWorld.build(seed=11, extent=30.0, n_ground=25000,
                                 max_points_per_scan=8192, noise=0.02)
    traj = circle_trajectory(n_frames, radius=12.0, laps=1.1)
    frames = [(i * 0.1, world.scan(p, seed=i)) for i, p in enumerate(traj)]
    robot = Robot(cfg, device=device)
    res = replay(robot, frames, tick_every=15, gt_xyz=traj[:, :3])
    if verbose:
        print(f"synthetic demo on {robot.device}: {n_frames} frames, "
              f"{len(res.keyframe_trajectory)} keyframes, {res.num_loops} "
              f"loops, ATE {res.ate:.3f} m, {res.frames_per_s:.1f} frames/s")
    return res
