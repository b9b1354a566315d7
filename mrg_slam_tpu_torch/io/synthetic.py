"""Synthetic LiDAR world for tests and `chip_smoke.py` (numpy only).

A copy of the JAX package's io/synthetic.py, so the port builds the same
worlds and scans, bit for bit, from the same seeds without that package:
a fixed set of world surface points (ground, pillars, walls); a scan at a
pose is the set of world points within sensor range, in the sensor frame,
with Gaussian noise. Revisiting a place reproduces the same structure.
Optional moving objects (`build(n_dynamic=)`, `scan(t=)`) add their own
clusters to a scan and shadow the static world behind them.
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
    # moving objects (cars/pedestrians): (D,3) start centers, (D,3)
    # velocities, (D,) radii. They inject non-static cluster points into
    # scans AND occlude the static world behind them — the dataset
    # realism axis the reference gets for free from KITTI's traffic
    dyn_p0: np.ndarray = None
    dyn_vel: np.ndarray = None
    dyn_size: np.ndarray = None

    @staticmethod
    def build(seed: int = 0, extent: float = 60.0, n_ground: int = 60000,
              n_pillars: int = 40, n_walls: int = 12,
              max_range: float = 35.0, noise: float = 0.01,
              max_points_per_scan: int = 8192,
              flat_ground: bool = False,
              n_dynamic: int = 0) -> "SyntheticWorld":
        rng = np.random.default_rng(seed)
        pts: List[np.ndarray] = []
        # ground: gently undulating by default, exactly planar for
        # floor-constraint scenarios (flat_ground=True)
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
        # walls (random vertical planes segments)
        for _ in range(n_walls):
            x0, y0 = rng.uniform(-extent, extent, 2)
            ang = rng.uniform(0, np.pi)
            length = rng.uniform(8, 25)
            n = 2500
            s = rng.uniform(0, length, n)
            z = rng.uniform(0, 3.0, n)
            pts.append(np.stack([x0 + s * np.cos(ang), y0 + s * np.sin(ang), z],
                                axis=1))
        world = np.concatenate(pts).astype(np.float32)
        dyn_p0 = dyn_vel = dyn_size = None
        if n_dynamic:
            dyn_p0 = np.stack([
                rng.uniform(-0.7 * extent, 0.7 * extent, n_dynamic),
                rng.uniform(-0.7 * extent, 0.7 * extent, n_dynamic),
                np.full(n_dynamic, 0.8)], axis=1).astype(np.float32)
            ang = rng.uniform(0, 2 * np.pi, n_dynamic)
            speed = rng.uniform(0.5, 2.0, n_dynamic)
            dyn_vel = np.stack([speed * np.cos(ang), speed * np.sin(ang),
                                np.zeros(n_dynamic)], axis=1).astype(
                                    np.float32)
            dyn_size = rng.uniform(0.6, 1.4, n_dynamic).astype(np.float32)
        return SyntheticWorld(points=world, rng=rng, max_range=max_range,
                              noise=noise,
                              max_points_per_scan=max_points_per_scan,
                              dyn_p0=dyn_p0, dyn_vel=dyn_vel,
                              dyn_size=dyn_size)

    def scan(self, pose: np.ndarray, seed: int = 0,
             t: float = 0.0) -> np.ndarray:
        """LiDAR scan in the sensor frame at 7-vec pose [t, q(wxyz)].

        With dynamic objects (`build(n_dynamic=...)`), `t` is the scan
        time: each object sits at p0 + vel*t, contributes its own surface
        cluster to the scan, and SHADOWS the static world behind it
        (points whose line of sight passes within the object's radius are
        dropped) — moving occluders like KITTI's traffic, which loop
        closure and odometry must reject as non-repeatable structure."""
        tr = pose[:3]
        d = self.points - tr[None, :]
        dist = np.linalg.norm(d, axis=1)
        sel = (dist < self.max_range) & (dist > self.min_range)
        local = d[sel]
        srng = np.random.default_rng(seed)
        if self.dyn_p0 is not None:
            centers = self.dyn_p0 + self.dyn_vel * t   # world frame
            c_rel = centers - tr[None, :]
            ldist = np.linalg.norm(local, axis=1)
            vhat = local / np.maximum(ldist, 1e-6)[:, None]
            occluded = np.zeros(local.shape[0], bool)
            for m in range(centers.shape[0]):
                along = vhat @ c_rel[m]
                perp2 = float(c_rel[m] @ c_rel[m]) - along ** 2
                occluded |= ((perp2 < self.dyn_size[m] ** 2)
                             & (along > 0) & (along < ldist))
            local = local[~occluded]
            # the objects' own surfaces enter the scan
            blobs = []
            for m in range(centers.shape[0]):
                if np.linalg.norm(c_rel[m]) > self.max_range:
                    continue
                n = 150
                th = srng.uniform(0, 2 * np.pi, n)
                z = srng.uniform(-0.7, 0.7, n)
                r = self.dyn_size[m]
                blobs.append(np.stack([
                    c_rel[m][0] + r * np.cos(th),
                    c_rel[m][1] + r * np.sin(th),
                    c_rel[m][2] + z], axis=1))
            if blobs:
                local = np.concatenate([local] + blobs)
        # world->sensor rotation: R^T
        R = _quat_to_mat_np(pose[3:7])
        local = local @ R  # == R.T @ d per point
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
    """(N,7) poses around a circle, heading tangent — closes a loop."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        x, y = radius * np.cos(th), radius * np.sin(th)
        yaw = th + np.pi / 2
        poses.append(_yaw_pose(x, y, z, yaw))
    return np.stack(poses)


def straight_trajectory(n_frames: int, speed: float = 1.0,
                        z: float = 1.5) -> np.ndarray:
    return np.stack([_yaw_pose(i * speed, 0.0, z, 0.0)
                     for i in range(n_frames)])


def figure8_trajectory(n_frames: int, radius: float = 18.0,
                       z: float = 1.5) -> np.ndarray:
    """(N,7) lemniscate poses — self-intersects, forcing loop closures."""
    poses = []
    ts = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    for th in ts:
        x = radius * np.sin(th)
        y = radius * np.sin(th) * np.cos(th)
        dx = radius * np.cos(th)
        dy = radius * np.cos(2 * th)
        poses.append(_yaw_pose(x, y, z, np.arctan2(dy, dx)))
    return np.stack(poses)
