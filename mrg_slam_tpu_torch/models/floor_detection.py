"""Ground-plane extraction per scan (apps/floor_detection_component.cpp).

Counterpart of the JAX package's models/floor_detection.py. The pipeline
(detect :100-190): tilt compensation -> height clip around the expected
floor level -> optional normal filtering (keep near-vertical normals) ->
batched plane RANSAC -> verticality check -> normal flip so that the
floor normal points up. Emits FloorCoeffs (n, d with n.x + d = 0, in the
base frame) or None.

It runs on the cloud's device and ends in one packed host read of the
coefficients, the inlier count and the verdict (the JAX package reads
the verdict and the count, then the coefficients). The RANSAC triplets
come from `sampler(mask, H)`, by default `ransac.sample_triplets` on a
torch.Generator seeded with `seed` on the cloud's device.

The reference declares `enable_normal_filtering` but reads
`use_normal_filtering` (:61 vs :120); as in the JAX package, one flag
controls it here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import FloorDetectionConfig
from ..ops.cloud import PointCloud, pad_invalid
from ..ops.ransac import estimate_normals, ransac_plane, sample_triplets
from ..utils import se3

# sampler(mask (N,) bool, H) -> (H, 3) int64 ranks among the valid lanes
Sampler = Callable[[torch.Tensor, int], torch.Tensor]


@dataclasses.dataclass
class FloorCoeffs:
    stamp: float
    coeffs: np.ndarray  # (4,)


class FloorDetection:
    def __init__(self, cfg: FloorDetectionConfig, seed: int = 0,
                 sampler: Optional[Sampler] = None):
        self.cfg = cfg
        self.seed = seed
        self._generator: Optional[torch.Generator] = None
        self.sampler = sampler or self._sample

    def _sample(self, mask: torch.Tensor, num: int) -> torch.Tensor:
        if self._generator is None or self._generator.device != mask.device:
            self._generator = torch.Generator(device=mask.device)
            self._generator.manual_seed(self.seed)
        return sample_triplets(mask, num, self._generator)

    def detect(self, cloud: PointCloud, stamp: float = 0.0
               ) -> Optional[FloorCoeffs]:
        """The floor plane of a filtered scan (N, 3), or None when the
        fit fails the checks or has fewer than floor_pts_thresh
        inliers."""
        coeffs, n_inliers, ok = detect_floor(cloud, self.cfg, self.sampler)
        head = torch.cat([coeffs, n_inliers.to(coeffs.dtype)[None],
                          ok.to(coeffs.dtype)[None]]).cpu().numpy()
        if not head[5] or head[4] < self.cfg.floor_pts_thresh:
            return None
        return FloorCoeffs(stamp=stamp, coeffs=head[:4].astype(np.float32))


def _cos_deg(deg: float) -> float:
    """cos of an angle in degrees, in float32 (as the JAX package), as a
    host scalar: a comparison with it uploads nothing."""
    return float(np.cos(np.float32(math.radians(deg))))


def detect_floor(cloud: PointCloud, cfg: FloorDetectionConfig,
                 sampler: Sampler
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (coeffs (4,) in the base frame, inlier count, verdict), all on
    the device."""
    # tilt compensation (:109-116): un-rotate the sensor's pitch; the
    # rotation vector is made on the device from a host scalar (a
    # host-to-device copy would sync the stream)
    axis = torch.arange(3, device=cloud.points.device)
    tilt = torch.where(axis == 1, math.radians(cfg.tilt_deg), 0.0).to(
        cloud.points.dtype)
    R = se3.so3_exp(tilt)
    pts = cloud.points @ R.T
    # height clip around the floor level z = -sensor_height (:192-214)
    z = pts[..., 2]
    h, r = cfg.sensor_height, cfg.height_clip_range
    mask = cloud.mask & (z > -h - r) & (z < -h + r)
    clipped = PointCloud(pad_invalid(pts, mask), mask)
    if cfg.enable_normal_filtering:
        normals = estimate_normals(clipped, k=10)
        mask = mask & (torch.abs(normals[..., 2])
                       > _cos_deg(cfg.normal_filter_thresh_deg))
        clipped = PointCloud(pad_invalid(clipped.points, mask), mask)
    fit = ransac_plane(clipped, sampler(mask, cfg.ransac_iterations),
                       cfg.ransac_distance_thresh)
    # verticality check (:153-161): the plane normal must be near +-z
    vertical = torch.abs(fit.coeffs[2]) > _cos_deg(
        cfg.floor_normal_thresh_deg)
    # normal flip (:165): the normal points up
    coeffs = torch.where(fit.coeffs[2] < 0, -fit.coeffs, fit.coeffs)
    # undo the tilt so that the coefficients live in the base frame
    coeffs = torch.cat([R.T @ coeffs[:3], coeffs[3:4]])
    return coeffs, fit.num_inliers, fit.valid & vertical
