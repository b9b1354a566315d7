"""Synthesize a ground disc under the first keyframe
(src/pcl/fill_ground_plane.cpp).

Counterpart of the JAX package's ops/ground_fill.py. Helps navigation
stacks that need a complete costmap under the robot at startup:
RANSAC-fit the dominant plane of the first cloud (`ransac` variant, :22)
or take the base pose's z = 0 plane (`simple` variant, :38), then sample
concentric rings at the map resolution (`fill_cloud` :51-66).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..utils import se3
from .cloud import PointCloud, merge
from .ransac import ransac_plane, sample_triplets

# RANSAC hypotheses of the ransac variant (the JAX package's default)
NUM_HYPOTHESES = 256


def _ring_points(center: np.ndarray, normal: np.ndarray, radius: float,
                 resolution: float) -> np.ndarray:
    """Concentric rings on the plane through `center` with `normal`."""
    n = normal / max(np.linalg.norm(normal), 1e-12)
    ref = np.asarray([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.asarray(
        [0.0, 1.0, 0])
    b1 = np.cross(n, ref)
    b1 /= max(np.linalg.norm(b1), 1e-12)
    b2 = np.cross(n, b1)
    pts = [center]
    r = resolution
    while r <= radius:
        count = max(8, int(round(2 * math.pi * r / resolution)))
        th = np.linspace(0, 2 * math.pi, count, endpoint=False)
        ring = (center[None, :] + np.outer(r * np.cos(th), b1)
                + np.outer(r * np.sin(th), b2))
        pts.append(ring)
        r += resolution
    return np.concatenate([p.reshape(-1, 3) for p in pts]).astype(np.float32)


def _with_disc(cloud: PointCloud, disc: np.ndarray) -> PointCloud:
    extra = PointCloud.from_array(disc, capacity=len(disc),
                                  device=cloud.points.device)
    return merge(cloud, extra, capacity=cloud.capacity + len(disc))


def fill_ground_plane_ransac(cloud: PointCloud, radius: float,
                             resolution: float, seed: int = 0,
                             triplets: Optional[torch.Tensor] = None
                             ) -> PointCloud:
    """RANSAC the dominant plane of `cloud` (triplets drawn from a
    generator seeded with `seed`, or the given ones) and fill a disc
    around its centroid projected onto the plane."""
    if triplets is None:
        gen = torch.Generator(device=cloud.points.device)
        gen.manual_seed(seed)
        triplets = sample_triplets(cloud.mask, NUM_HYPOTHESES, gen)
    fit = ransac_plane(cloud, triplets, distance_thresh=resolution)
    head = torch.cat([fit.coeffs, fit.valid.to(fit.coeffs.dtype)[None]])
    head = head.cpu().numpy()  # one read for the fit
    pts = cloud.points[cloud.mask].cpu().numpy()
    if not head[4] or len(pts) == 0:
        return cloud
    n = head[:3]
    center = pts.mean(axis=0)
    # the centroid onto the plane: c - (n.c + d) n
    center = center - (float(n @ center) + head[3]) * n
    return _with_disc(cloud, _ring_points(center, n, radius, resolution))


def fill_ground_plane_simple(cloud: PointCloud, base_pose: np.ndarray,
                             radius: float, resolution: float) -> PointCloud:
    """A disc on the base pose's own xy-plane (z = 0 in the base frame)."""
    R = se3.pose_rotation(torch.from_numpy(
        np.asarray(base_pose, np.float32))).numpy()
    center = np.asarray(base_pose[:3], np.float64)
    disc = _ring_points(center.astype(np.float32),
                        R[:, 2].astype(np.float32), radius, resolution)
    return _with_disc(cloud, disc)
