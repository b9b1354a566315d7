"""The system under test: mrg_slam_tpu_torch driven block by block.

Everything the benchmark takes from the program passes through here: its
config classes, its four layers (`ops.prefilter.prefilter`,
`models.odometry_fused.run_batch` / `run_batch_multi`, `process_scan` on
`models.backend.MrgSlam` / `models.shared_graph.SharedGraphSlam`,
`optimization_tick`), its kernel launch counters and `TickStats`. The
outputs a run keeps for the judge are plain numpy and tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List

import numpy as np
import torch

NAMES = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel")


def _build(cls, values: dict):
    """A config dataclass from the port's defaults and `values`; a dict
    value fills a nested config dataclass, a list a tuple."""
    obj = cls()
    changes = {}
    for k, v in values.items():
        cur = getattr(obj, k)  # an unknown key raises
        if isinstance(v, dict) and dataclasses.is_dataclass(cur):
            changes[k] = _build(type(cur), v)
        elif isinstance(v, list):
            changes[k] = tuple(v)
        else:
            changes[k] = v
    return dataclasses.replace(obj, **changes)


def port_configs(cfg: dict):
    """(prefilter, odometry, slam) configs of the port from a config file."""
    from mrg_slam_tpu_torch.config import (PrefilterConfig,
                                           ScanMatchingOdometryConfig,
                                           SlamConfig)
    p = cfg["port"]
    return (_build(PrefilterConfig, p["prefilter"]),
            _build(ScanMatchingOdometryConfig, p["odometry"]),
            _build(SlamConfig, p["slam"]))


def init_pose_of(p: np.ndarray) -> tuple:
    """(x, y, z, yaw, pitch, roll) of a planar 7-vector pose."""
    yaw = 2.0 * math.atan2(float(p[6]), float(p[3]))
    return (float(p[0]), float(p[1]), float(p[2]), yaw, 0.0, 0.0)


class Spans:
    """Host wall time per layer around the program's calls; with
    `traced`, each call is also a `torch.profiler.record_function` range
    named `bench.<layer>`. Nothing here synchronizes the device."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.wall: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function("bench." + name)
              if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.wall[name] = self.wall.get(name, 0.0) + time.perf_counter() - t0


@dataclasses.dataclass
class EpisodeRun:
    """One episode's program state and what the judge and readers need."""

    episode: object                 # traffic.Episode
    slam: object                    # MrgSlam or SharedGraphSlam
    carry: object                   # the odometry carry (robot-stacked)
    host: List[np.ndarray] = dataclasses.field(default_factory=list)
    clouds: List[tuple] = dataclasses.field(default_factory=list)
    ticks: List[object] = dataclasses.field(default_factory=list)
    # the graph's host copy of its node estimates after each tick with
    # work (a copy of a small numpy array; the loop judge's state)
    snaps: List[np.ndarray] = dataclasses.field(default_factory=list)
    blocks: int = 0

    @property
    def complete(self) -> bool:
        return self.blocks == self.episode.rows.shape[0]


class System:
    """The port at one configuration, on one device."""

    def __init__(self, cfg: dict, device):
        from mrg_slam_tpu_torch.ops import registration as reg
        self.cfg, self.device = cfg, torch.device(device)
        self.pre, self.odo, self.slam_cfg = port_configs(cfg)
        self.R, self.B = cfg["robots"], cfg["block_frames"]
        self.P = cfg["filtered_points"]
        self.dt = cfg["frame_period_s"]
        self.names = list(NAMES[:self.R]) if self.R > 1 else [
            self.slam_cfg.own_name]
        self.covs_ok = reg.covariance_compatible(self.odo.registration,
                                                 self.slam_cfg.registration)

    def start(self, episode, windows) -> EpisodeRun:
        """A fresh back end and odometry carry for an episode."""
        from mrg_slam_tpu_torch.models import odometry_fused as fused
        dev = self.device
        if self.R == 1:
            from mrg_slam_tpu_torch.models.backend import MrgSlam
            slam = MrgSlam(self.slam_cfg, device=dev)
            carry = fused.init_carry(self.P, device=dev)
        else:
            from mrg_slam_tpu_torch.models.shared_graph import \
                SharedGraphSlam
            slam = SharedGraphSlam(
                self.slam_cfg, self.names,
                {n: init_pose_of(episode.truth[a])
                 for n, (a, _) in zip(self.names, windows)}, device=dev)
            carry = fused.stack_carries([fused.init_carry(self.P, device=dev)
                                         for _ in self.names])
        return EpisodeRun(episode, slam, carry)

    def block(self, run: EpisodeRun, spans: Spans) -> None:
        """The episode's next block through the four layers."""
        from mrg_slam_tpu_torch.models import odometry_fused as fused
        from mrg_slam_tpu_torch.ops.cloud import PointCloud
        from mrg_slam_tpu_torch.ops.prefilter import prefilter
        b, B, R = run.blocks, self.B, self.R
        ep = run.episode
        stamps = (torch.arange(b * B, (b + 1) * B, device=self.device,
                               dtype=torch.float32) * self.dt)
        with spans("prefilter"):
            c = prefilter(PointCloud(ep.raw[b], ep.mask[b]), self.pre)
        with spans("odometry"):
            if R == 1:
                run.carry, outs = fused.run_batch(self.odo, run.carry,
                                                  c.points, c.mask, stamps)
            else:
                run.carry, outs = fused.run_batch_multi(
                    self.odo, run.carry, c.points.view(R, B, self.P, 3),
                    c.mask.view(R, B, self.P), stamps.expand(R, B))
            # the block's one read: poses, GN iterations, keyframe flags
            # and inliers together
            host = torch.cat([outs.pose, outs.iterations[..., None].float(),
                              outs.is_new_keyframe[..., None].float(),
                              outs.num_inliers[..., None].float()],
                             -1).reshape(R * B, 10).cpu().numpy()
        covs = outs.covs.reshape(R * B, self.P, 3, 3) if self.covs_ok \
            else None
        with spans("ingest"):
            for row in range(R * B):
                r, i = divmod(row, B)
                cloud = PointCloud(c.points[row], c.mask[row])
                cv = covs[row] if covs is not None else None
                stamp = (b * B + i) * self.dt
                if R == 1:
                    run.slam.process_scan(stamp, host[row, :7], cloud,
                                          source_covs=cv)
                else:
                    run.slam.process_scan(self.names[r], stamp,
                                          host[row, :7], cloud,
                                          source_covs=cv)
        with spans("tick"):
            st = run.slam.optimization_tick(now=(b + 1) * B * self.dt)
        if st is not None:
            run.snaps.append(run.slam.db.graph.poses.copy())
        run.host.append(host)
        run.clouds.append((c.points, c.mask))
        run.ticks.append(st)
        run.blocks += 1


def launches() -> Dict[str, int]:
    """The port's own launch counters of its hand kernels."""
    from mrg_slam_tpu_torch.ops import nn_kernel, stats_kernel
    return {"nn": nn_kernel.nn_cuda.launches,
            "count": stats_kernel.count_cuda.launches,
            "moments": stats_kernel.moments_cuda.launches}


def outputs(system: System, run: EpisodeRun, windows) -> dict:
    """What the judge reads of an episode's program outputs, as plain
    data: per robot the odometry poses, keyframe flags and GN iterations
    of every frame it ran; the keyframes (frame, graph node, odometry
    pose, final estimate) in stamp order; the loop edges (robot and frame
    of each end, measurement) in the order they were made; the graph's
    node estimates after each tick; the filtered clouds of every
    block."""
    R, B = system.R, system.B
    host = np.stack(run.host)  # (blocks, R*B, 10)
    n = host.shape[0]
    per = host.reshape(n, R, B, 10).transpose(1, 0, 2, 3).reshape(R, n * B,
                                                                  10)
    slam = run.slam
    db = slam.db
    robots = []
    frame_of = {}
    for r, name in enumerate(system.names):
        kfs = (slam.db.own_keyframes() if R == 1
               else slam.robot_keyframes(name))
        kfs = sorted(kfs, key=lambda k: k.stamp)
        frames = [int(round(k.stamp / system.dt)) for k in kfs]
        for k, f in zip(kfs, frames):
            frame_of[k.uuid] = (r, f)
        robots.append(dict(
            name=name, window=windows[r], poses=per[r, :, :7],
            iterations=per[r, :, 7], new_keyframe=per[r, :, 8] > 0.5,
            inliers=per[r, :, 9], keyframe_frames=frames,
            keyframe_nodes=[int(k.node_id) for k in kfs],
            keyframe_odom=np.stack([k.odom for k in kfs]) if kfs else None,
            keyframe_estimate=(np.stack([k.estimate(db.graph) for k in kfs])
                               if kfs else None)))
    loops = []
    for e in db.edges:
        if e.type != "loop":
            continue
        a, c = frame_of.get(e.from_uuid), frame_of.get(e.to_uuid)
        if a is not None and c is not None:
            loops.append((a, c, np.asarray(e.relative_pose, np.float64)))
    return dict(robots=robots, loops=loops, clouds=run.clouds,
                blocks=run.blocks, snaps=list(run.snaps))
