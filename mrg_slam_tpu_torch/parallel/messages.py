"""The message records the single-robot back end uses.

Counterpart of the part of the JAX package's parallel/messages.py (the
mrg_slam_msgs equivalent) that one robot's back end sends: its pose
broadcast and its status heartbeat. The graph exchange messages wait for
the multi-robot services (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PoseWithName:
    robot_name: str
    stamp: float
    pose: np.ndarray              # (7,)
    accum_dist: float


@dataclasses.dataclass
class SlamStatus:
    """Heartbeat mirror of mrg_slam_msgs/SlamStatus."""

    robot_name: str = ""
    initialized: bool = False
    in_graph_exchange: bool = False
    in_loop_closure: bool = False
    in_optimization: bool = False
