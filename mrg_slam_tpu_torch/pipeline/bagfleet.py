"""Multi-robot SLAM driven from one rosbag.

Counterpart of the JAX package's pipeline/bagfleet.py, the no-ROS
equivalent of the reference's Nebula fleet processor
(python_scripts/nebula_multirobot_processor.py:70-95): each robot's
PointCloud2 stream is read out of one sqlite3 .db3 bag by topic name,
each robot gets a full SLAM stack, and the fleet replays in lock step
with the uuid-delta graph exchange between them (`replay_multirobot`).

Library:  run_fleet_from_bag(cfg, bag, names, ...)
CLI:      python -m mrg_slam_tpu_torch.launch --dataset rosbag \\
              --bag fleet.db3 --robots husky1,husky2 \\
              [--topic-template '/{robot}/points']
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.rosbag import BagReader
from ..runtime import DeviceLike


def read_fleet_frames(bag_file: str, robot_names: Sequence[str],
                      topic_template: str = "/{robot}/velodyne_points",
                      max_frames: int = 0
                      ) -> Dict[str, List[Tuple[float, np.ndarray]]]:
    """Each robot's (stamp, xyz) frames from one multi-topic bag, the
    first `max_frames` of them when it is positive."""
    bag = BagReader(bag_file)
    try:
        out = {}
        for name in robot_names:
            topic = topic_template.format(robot=name)
            if topic not in bag.topic_id:
                raise KeyError(f"bag has no topic {topic!r} (topics: "
                               f"{sorted(bag.topic_id)})")
            frames = list(bag.pointclouds(topic))
            out[name] = frames[:max_frames] if max_frames > 0 else frames
        return out
    finally:
        bag.close()


def run_fleet_from_bag(cfg, bag_file: str, robot_names: Sequence[str],
                       topic_template: str = "/{robot}/velodyne_points",
                       tick_every: int = 8,
                       init_poses: Optional[Dict[str, tuple]] = None,
                       max_frames: int = 0, device: DeviceLike = None):
    """Fleet SLAM from a bag: one Robot a topic, on the card unless
    `device` says otherwise, replayed in lock step with the graph
    exchange. Returns ({robot: Robot}, {robot: ReplayResult}).

    `cfg` is an EngineConfig template; each robot gets it with its
    own_name, the fleet's multi_robot_names and its init_pose from
    `init_poses` (x, y, z, yaw, pitch, roll), as the reference launches
    one namespaced component container per robot with x/y/z arguments
    (launch/mrg_slam.launch.py).
    """
    from .replay import Robot, replay_multirobot

    frames = read_fleet_frames(bag_file, robot_names, topic_template,
                               max_frames)
    robots = {}
    for name in robot_names:
        slam_cfg = dataclasses.replace(
            cfg.slam, own_name=name, multi_robot_names=tuple(robot_names),
            init_pose=(tuple(init_poses[name]) if init_poses
                       and name in init_poses else cfg.slam.init_pose))
        robots[name] = Robot(dataclasses.replace(cfg, slam=slam_cfg),
                             device=device)
    results = replay_multirobot(robots, frames, tick_every=tick_every)
    return robots, results
