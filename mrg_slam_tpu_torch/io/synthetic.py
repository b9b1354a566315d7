"""Synthetic LiDAR world for tests and `chip_smoke.py` (numpy only).

A copy of the static-world part of the JAX package's io/synthetic.py, so
the port builds the same worlds from the same seeds without that package:
a fixed set of world surface points (ground, pillars, walls); a scan at a
pose is the set of world points within sensor range, in the sensor frame,
with Gaussian noise. Revisiting a place reproduces the same structure.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SyntheticWorld:
    points: np.ndarray  # (M, 3) world surface points
    rng: np.random.Generator
    max_range: float = 35.0
    min_range: float = 0.5
    noise: float = 0.01
    max_points_per_scan: int = 8192

    @staticmethod
    def build(seed: int = 0, extent: float = 60.0, n_ground: int = 60000,
              n_pillars: int = 40, n_walls: int = 12,
              max_range: float = 35.0, noise: float = 0.01,
              max_points_per_scan: int = 8192,
              flat_ground: bool = False) -> "SyntheticWorld":
        rng = np.random.default_rng(seed)
        pts: List[np.ndarray] = []
        # ground: gently undulating, or exactly planar with flat_ground
        g = np.stack([
            rng.uniform(-extent, extent, n_ground),
            rng.uniform(-extent, extent, n_ground),
            np.zeros(n_ground),
        ], axis=1)
        if not flat_ground:
            g[:, 2] = 0.05 * np.sin(g[:, 0] * 0.15) * np.cos(g[:, 1] * 0.11)
        pts.append(g)
        # pillars (vertical cylinders)
        for _ in range(n_pillars):
            cx, cy = rng.uniform(-extent, extent, 2)
            r = rng.uniform(0.2, 0.8)
            h = rng.uniform(2.0, 6.0)
            n = 600
            th = rng.uniform(0, 2 * np.pi, n)
            z = rng.uniform(0, h, n)
            pts.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th), z],
                                axis=1))
        # walls (random vertical plane segments)
        for _ in range(n_walls):
            x0, y0 = rng.uniform(-extent, extent, 2)
            ang = rng.uniform(0, np.pi)
            length = rng.uniform(8, 25)
            n = 2500
            s = rng.uniform(0, length, n)
            z = rng.uniform(0, 3.0, n)
            pts.append(np.stack([x0 + s * np.cos(ang), y0 + s * np.sin(ang),
                                 z], axis=1))
        world = np.concatenate(pts).astype(np.float32)
        return SyntheticWorld(points=world, rng=rng, max_range=max_range,
                              noise=noise,
                              max_points_per_scan=max_points_per_scan)

    def scan(self, pose: np.ndarray, seed: int = 0) -> np.ndarray:
        """LiDAR scan in the sensor frame at 7-vector pose [t, q(wxyz)]."""
        tr = pose[:3]
        d = self.points - tr[None, :]
        dist = np.linalg.norm(d, axis=1)
        sel = (dist < self.max_range) & (dist > self.min_range)
        local = d[sel]
        srng = np.random.default_rng(seed)
        # world->sensor rotation: R^T
        local = local @ _quat_to_mat_np(pose[3:7])  # == R.T @ d per point
        if local.shape[0] > self.max_points_per_scan:
            idx = srng.choice(local.shape[0], self.max_points_per_scan,
                              replace=False)
            local = local[idx]
        if self.noise > 0:
            local = local + srng.normal(scale=self.noise, size=local.shape)
        return local.astype(np.float32)


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def _yaw_pose(x: float, y: float, z: float, yaw: float) -> np.ndarray:
    return np.array([x, y, z, np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                    dtype=np.float32)


def circle_trajectory(n_frames: int, radius: float = 20.0,
                      z: float = 1.5, laps: float = 1.0) -> np.ndarray:
    """(N, 7) poses around a circle, heading tangent; closes a loop."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        x, y = radius * np.cos(th), radius * np.sin(th)
        poses.append(_yaw_pose(x, y, z, th + np.pi / 2))
    return np.stack(poses)
