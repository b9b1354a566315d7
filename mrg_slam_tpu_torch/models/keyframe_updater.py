"""Keyframe admission gate (src/mrg_slam/keyframe_updater.cpp).

A copy of the JAX package's models/keyframe_updater.py (host numpy).

Accept a frame as keyframe when its pose moved more than
`keyframe_delta_trans` or rotated more than `keyframe_delta_angle` since the
last accepted keypose; tracks the accumulated travel distance used by the
loop detector's candidate filters.
"""

from __future__ import annotations

import numpy as np


class KeyframeUpdater:
    def __init__(self, keyframe_delta_trans: float,
                 keyframe_delta_angle: float):
        self.delta_trans = float(keyframe_delta_trans)
        self.delta_angle = float(keyframe_delta_angle)
        self.is_first = True
        self.accum_distance = 0.0
        self._prev_keypose: np.ndarray | None = None  # (7,)

    def update(self, pose: np.ndarray) -> bool:
        """Return True if `pose` (7-vec, odom frame) becomes a keyframe."""
        pose = np.asarray(pose, dtype=np.float64)
        if self.is_first:
            self.is_first = False
            self._prev_keypose = pose
            return True
        dt = np.linalg.norm(pose[:3] - self._prev_keypose[:3])
        # relative rotation angle via quaternion dot product
        dq = abs(float(np.dot(pose[3:7], self._prev_keypose[3:7])))
        da = 2.0 * np.arccos(min(1.0, dq))
        if dt < self.delta_trans and da < self.delta_angle:
            return False
        self.accum_distance += dt
        self._prev_keypose = pose
        return True
