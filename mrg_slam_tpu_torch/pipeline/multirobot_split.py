"""Multi-robot splits of a single-robot sequence.

Counterpart of the JAX package's pipeline/multirobot_split.py, the
equivalent of kitti_multirobot_processor.py (:64-66 min_times / max_times
windows) and kitti_multirobot_reversed_processor.py: one sequence cut
into overlapping per-robot frame windows, a robot's window optionally
played backwards so the robots drive toward each other (which forces
inter-robot loop closures), then the in-process multi-robot replay.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import EngineConfig
from ..runtime import DeviceLike
from .replay import ReplayResult, Robot, replay_multirobot

Frame = Tuple[float, np.ndarray]


def split_windows(n_frames: int, n_robots: int,
                  overlap_fraction: float = 0.25) -> List[Tuple[int, int]]:
    """Overlapping [start, end) frame windows, one a robot."""
    if n_robots == 1:
        return [(0, n_frames)]
    base = n_frames / n_robots
    half_ov = int(base * overlap_fraction / 2)
    return [(max(0, int(r * base) - half_ov),
             min(n_frames, int((r + 1) * base) + half_ov))
            for r in range(n_robots)]


def split_frames(frames: Sequence[Frame], n_robots: int,
                 overlap_fraction: float = 0.25,
                 reversed_robots: Sequence[int] = ()) -> List[List[Frame]]:
    """Per-robot frame lists; a window in `reversed_robots` plays its
    scans backwards under the window's own increasing stamps."""
    out: List[List[Frame]] = []
    for r, (s, e) in enumerate(split_windows(len(frames), n_robots,
                                             overlap_fraction)):
        chunk = list(frames[s:e])
        if r in reversed_robots:
            chunk = list(zip([f[0] for f in chunk],
                             [f[1] for f in reversed(chunk)]))
        out.append(chunk)
    return out


def run_multirobot_split(base_cfg: EngineConfig, frames: Sequence[Frame],
                         robot_names: Sequence[str],
                         init_poses: Optional[Dict[str, tuple]] = None,
                         overlap_fraction: float = 0.25,
                         reversed_robots: Sequence[int] = (),
                         tick_every: int = 30, coordinate: bool = True,
                         device: DeviceLike = None
                         ) -> Tuple[Dict[str, ReplayResult],
                                    Dict[str, Robot]]:
    """One full SLAM stack a robot over the split windows, through
    `replay_multirobot` with the exchange (the reference's multirobot
    processors fan out subprocesses; here the robots share one process
    and, on the card unless `device` says otherwise, one card). Returns
    the results and the robots by name."""
    names = list(robot_names)
    per_robot = split_frames(frames, len(names), overlap_fraction,
                             reversed_robots)
    robots: Dict[str, Robot] = {}
    for name in names:
        slam_cfg = dataclasses.replace(
            base_cfg.slam, own_name=name, multi_robot_names=tuple(names))
        if init_poses and name in init_poses:
            slam_cfg = dataclasses.replace(slam_cfg,
                                           init_pose=init_poses[name])
        robots[name] = Robot(dataclasses.replace(base_cfg, slam=slam_cfg),
                             device=device)
    results = replay_multirobot(robots, dict(zip(names, per_robot)),
                                tick_every=tick_every, coordinate=coordinate)
    return results, robots
