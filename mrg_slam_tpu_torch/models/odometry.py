"""Scan-matching odometry, one frame at a time: frame-to-keyframe
registration with keyframe switching and transform-jump rejection.

Counterpart of the JAX package's models/odometry.py (apps/
scan_matching_odometry_component.cpp without ROS): the cloud callback
becomes `ScanMatchingOdometry.step`. The registration
(`ops.registration.align`) and the keyframe target (`make_target`, on a
keyframe switch: its covariances for the GICP family, its Gaussian voxel
map for VGICP and NDT) run on the cloud's device; the
state machine (keep-last, jump rejection, keyframe switch, the initial
guesses) runs on the host in numpy (`utils.se3np`), on values the host
reads back.

Host reads a frame: one per Gauss-Newton iteration of `align` (its exit
check), then one packed read of everything the host branches on: the
pose, the converged flag, the iterations, the inliers, the error and the
scan's valid point count. The first frame reads nothing.
`models/odometry_fused.py` is the device-resident form of the same state
machine, without the MSF and robot-odometry guesses.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ScanMatchingOdometryConfig
from ..ops import registration as reg
from ..ops import voxel
from ..ops.cloud import PointCloud
from ..utils import se3np


@dataclasses.dataclass
class ScanMatchingStatus:
    """Mirror of mrg_slam_msgs/ScanMatchingStatus
    (scan_matching_odometry_component.cpp:391-430)."""

    has_converged: bool = True
    matching_error: float = 0.0
    inlier_fraction: float = 1.0
    relative_pose: Optional[np.ndarray] = None
    prediction_labels: tuple = ()


class OdometryOutput(NamedTuple):
    pose: np.ndarray       # (7,) odom-frame pose of this scan
    delta: np.ndarray      # (7,) relative pose w.r.t. the previous scan
    is_new_keyframe: bool
    status: ScanMatchingStatus


class ScanMatchingOdometry:
    """Frame-to-keyframe odometry with internal keyframe switching."""

    def __init__(self, cfg: ScanMatchingOdometryConfig):
        self.cfg = cfg
        self.params = cfg.registration
        self._keyframe_pose: Optional[np.ndarray] = None  # odom frame (7,)
        self._keyframe_stamp: float = 0.0
        self._target = None  # RegistrationTarget of the keyframe cloud
        self._prev_rel = se3np.pose_identity()     # keyframe -> last scan
        self._last_delta = se3np.pose_identity()   # scan-to-scan
        self._prev_pose = se3np.pose_identity()
        self._rejections = 0
        # external initial-guess sources (:152-158, :210-263)
        self._msf_pose: Optional[tuple] = None               # (stamp, pose7)
        self._msf_pose_after_update: Optional[tuple] = None  # (stamp, pose7)
        self._robot_odom_prev: Optional[np.ndarray] = None   # pose7
        self._robot_odom_cur: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    # external initial-guess feeds
    # ------------------------------------------------------------------
    def msf_pose_callback(self, stamp: float, pose7: np.ndarray,
                          after_update: bool) -> None:
        """MSF-filtered pose stream (msf_core/pose[_after_update],
        scan_matching_odometry_component.cpp:152-158)."""
        entry = (float(stamp), np.asarray(pose7, np.float32))
        if after_update:
            self._msf_pose_after_update = entry
        else:
            self._msf_pose = entry

    def robot_odom_callback(self, pose7: np.ndarray) -> None:
        """Secondary robot odometry sample for this scan (the reference
        looks the same delta up from TF, :225-263)."""
        self._robot_odom_prev = self._robot_odom_cur
        self._robot_odom_cur = np.asarray(pose7, np.float32)

    def _msf_delta(self):
        """-> (delta7 | None, source label) per :210-263."""
        if self.cfg.enable_imu_frontend:
            if (self._msf_pose is not None
                    and self._msf_pose[0] > self._keyframe_stamp
                    and self._msf_pose_after_update is not None
                    and self._msf_pose_after_update[0] > self._keyframe_stamp):
                return se3np.pose_between(self._msf_pose_after_update[1],
                                          self._msf_pose[1]), "imu"
            return None, ""  # msf data too old (the reference warns, :223)
        if (self.cfg.enable_robot_odometry_init_guess
                and self._robot_odom_prev is not None):
            return se3np.pose_between(self._robot_odom_prev,
                                      self._robot_odom_cur), "odometry"
        return None, ""

    # ------------------------------------------------------------------
    def _downsample(self, cloud: PointCloud) -> PointCloud:
        if self.cfg.downsample_method in ("VOXELGRID", "APPROX_VOXELGRID"):
            return voxel.voxel_downsample(
                cloud, self.cfg.downsample_resolution,
                min_points=self.cfg.downsample_min_points_per_voxel,
                capacity=cloud.capacity)
        return cloud

    def _set_keyframe(self, cloud: PointCloud, pose: np.ndarray,
                      stamp: float) -> None:
        self._target = reg.make_target(cloud, self.params)
        self._keyframe_pose = np.asarray(pose, dtype=np.float32)
        self._keyframe_stamp = stamp
        self._prev_rel = se3np.pose_identity()

    # ------------------------------------------------------------------
    def step(self, cloud: PointCloud, stamp: float) -> OdometryOutput:
        """Process one prefiltered scan; returns the odometry estimate.

        Equivalent of cloud_callback + matching()
        (scan_matching_odometry_component.cpp:138,195).
        """
        cloud = self._downsample(cloud)
        if self._keyframe_pose is None:
            self._set_keyframe(cloud, se3np.pose_identity(), stamp)
            self._prev_pose = se3np.pose_identity()
            return OdometryOutput(
                pose=self._prev_pose, delta=se3np.pose_identity(),
                is_new_keyframe=True, status=ScanMatchingStatus())

        source = reg.make_source(cloud, self.params)
        # initial guess = prev_trans * msf_delta (:266); without the MSF
        # or robot-odometry guess, the last scan-to-scan delta (a
        # constant-velocity model, as the JAX package does)
        msf_delta, msf_source = self._msf_delta()
        delta_guess = (msf_delta if msf_delta is not None
                       else self._last_delta)
        guess = se3np.pose_compose(self._prev_rel, delta_guess)
        dev = cloud.points.device
        result = reg.align(self.params, source, self._target,
                           torch.from_numpy(guess).to(dev))
        # the frame's one packed read
        flags = torch.stack([result.converged.to(torch.float32),
                             result.iterations.to(torch.float32),
                             result.num_inliers.to(torch.float32),
                             result.error.to(torch.float32),
                             cloud.mask.sum().to(torch.float32)])
        host = torch.cat([result.pose.to(torch.float32), flags]).cpu().numpy()
        rel, (conv, iters, inliers, error, n_valid) = host[:7], host[7:]

        # keep-last on failure, as the fused path gates it: a solve that
        # lost every correspondence returns its garbage running pose, and
        # accepting it would poison `last_delta` and with it every later
        # guess. Solves that only ran out of iterations keep their
        # estimate, like the reference front end (:270-273).
        converged = bool(conv) or bool(iters > 0)
        if inliers <= 0 or not np.isfinite(rel).all():
            converged = False
        if not converged:
            rel = self._prev_rel
        else:
            rel = self._apply_jump_rejection(rel)

        pose = se3np.pose_compose(self._keyframe_pose, rel)
        delta = se3np.pose_between(self._prev_pose, pose)
        status = ScanMatchingStatus(
            has_converged=converged, matching_error=float(error),
            inlier_fraction=float(inliers) / max(1.0, float(n_valid)),
            relative_pose=rel,
            prediction_labels=(msf_source,) if msf_source else ())

        # keyframe switch on accumulated motion (:326-339)
        new_kf = (float(np.linalg.norm(rel[:3]))
                  > self.cfg.keyframe_delta_translation
                  or se3np.rotation_angle(rel[3:7])
                  > self.cfg.keyframe_delta_angle
                  or stamp - self._keyframe_stamp
                  > self.cfg.keyframe_delta_time)
        if new_kf:
            self._set_keyframe(cloud, pose, stamp)
        else:
            self._prev_rel = rel
        self._last_delta = delta
        self._prev_pose = pose
        return OdometryOutput(pose=pose, delta=delta, is_new_keyframe=new_kf,
                              status=status)

    # ------------------------------------------------------------------
    def _apply_jump_rejection(self, rel: np.ndarray) -> np.ndarray:
        """Transform thresholding (:278-315): reject implausible jumps,
        force-accept after max_consecutive_rejections to avoid deadlock."""
        if not self.cfg.enable_transform_thresholding:
            return rel
        delta = se3np.pose_between(self._prev_rel, rel)
        if (float(np.linalg.norm(delta[:3]))
                > self.cfg.max_acceptable_translation
                or se3np.rotation_angle(delta[3:7])
                > self.cfg.max_acceptable_angle):
            self._rejections += 1
            if self._rejections < self.cfg.max_consecutive_rejections:
                return self._prev_rel
        self._rejections = 0
        return rel
