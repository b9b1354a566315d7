"""GPS / IMU / FloorCoeffs processors: sensor queues -> prior edges.

Counterpart of the JAX package's models/processors.py (src/mrg_slam/
{gps,imu,floor_coeffs}_processor.cpp): each processor queues timestamped
measurements, and `flush` matches them to keyframes nearest in time
(within a tolerance) and adds the unary prior or plane edges to the
graph's host staging tables. Host code only (numpy).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import FloorCoeffsConfig, GpsConfig, ImuConfig
from ..utils import se3np
from ..utils.geodesy import LocalCartesian, latlon_to_utm
from .floor_detection import FloorCoeffs
from .graph_database import GraphDatabase
from .keyframe import KeyFrame


@dataclasses.dataclass
class GpsFix:
    stamp: float
    lat: float
    lon: float
    alt: float


class GpsProcessor:
    """gps_processor.cpp: NavSat queue -> SE3PriorXY/XYZ edges.

    UTM mode subtracts the first fix (`zero_utm`); ENU mode uses a
    LocalCartesian anchored at the configured or first-fix origin.
    """

    def __init__(self, cfg: GpsConfig):
        self.cfg = cfg
        self.queue: List[GpsFix] = []
        self.zero_utm: Optional[np.ndarray] = None
        self.enu: Optional[LocalCartesian] = None
        if cfg.gps_use_enu and not cfg.gps_enu_origin_from_msg:
            o = cfg.gps_enu_origin
            self.enu = LocalCartesian(o[0], o[1], o[2])

    def add_fix(self, fix: GpsFix) -> None:
        self.queue.append(fix)

    def _to_local(self, fix: GpsFix) -> np.ndarray:
        if self.cfg.gps_use_enu:
            if self.enu is None:
                self.enu = LocalCartesian(fix.lat, fix.lon, fix.alt)
            return self.enu.forward(fix.lat, fix.lon, fix.alt)
        e, n, _ = latlon_to_utm(fix.lat, fix.lon)
        xyz = np.asarray([e, n, fix.alt])
        if self.zero_utm is None:
            self.zero_utm = xyz.copy()
        return xyz - self.zero_utm

    def flush(self, db: GraphDatabase, keyframes: Sequence[KeyFrame]) -> bool:
        if not self.cfg.enable_gps or not self.queue:
            return False
        updated = False
        remaining: List[GpsFix] = []
        stamps = [f.stamp for f in self.queue]
        for kf in keyframes:
            if kf.node_id is None or kf.utm_coord is not None:
                continue
            i = bisect.bisect_left(stamps, kf.stamp)
            best, best_dt = None, self.cfg.gps_time_tolerance
            for j in (i - 1, i):
                if 0 <= j < len(self.queue):
                    dt = abs(self.queue[j].stamp - kf.stamp)
                    if dt <= best_dt:
                        best, best_dt = self.queue[j], dt
            if best is None:
                continue
            xyz = self._to_local(best)
            kf.utm_coord = xyz
            c = self.cfg
            if best.alt is None or math.isnan(best.alt):
                info = np.eye(2) / (c.gps_edge_stddev_xy ** 2)
                db.graph.add_se3_prior_xy_edge(
                    kf.node_id, xyz[:2], info,
                    kernel=c.gps_edge_robust_kernel,
                    kernel_delta=c.gps_edge_robust_kernel_size)
            else:
                info = np.diag([1 / c.gps_edge_stddev_xy ** 2,
                                1 / c.gps_edge_stddev_xy ** 2,
                                1 / c.gps_edge_stddev_z ** 2])
                db.graph.add_se3_prior_xyz_edge(
                    kf.node_id, xyz, info,
                    kernel=c.gps_edge_robust_kernel,
                    kernel_delta=c.gps_edge_robust_kernel_size)
            updated = True
        # drop measurements older than the newest keyframe (reference keeps
        # a sliding queue)
        if keyframes:
            newest = max(k.stamp for k in keyframes)
            remaining = [f for f in self.queue
                         if f.stamp > newest - self.cfg.gps_time_tolerance]
        self.queue = remaining
        return updated


@dataclasses.dataclass
class ImuSample:
    stamp: float
    quat: np.ndarray       # (4,) wxyz orientation in imu frame
    acc: np.ndarray        # (3,) linear acceleration in imu frame


class ImuProcessor:
    """imu_processor.cpp: orientation and/or gravity-vector prior edges."""

    def __init__(self, cfg: ImuConfig,
                 base_T_imu: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.queue: List[ImuSample] = []
        # static transform base<-imu (7-vec); identity if colocated
        self.base_T_imu = (np.asarray(base_T_imu, np.float32)
                           if base_T_imu is not None
                           else se3np.pose_identity())
        # keyframes that already have their IMU priors
        self._done: set = set()

    def add_sample(self, s: ImuSample) -> None:
        self.queue.append(s)

    def flush(self, db: GraphDatabase, keyframes: Sequence[KeyFrame]) -> bool:
        c = self.cfg
        if not (c.enable_imu_orientation or c.enable_imu_acceleration):
            return False
        if not self.queue:
            return False
        updated = False
        stamps = [s.stamp for s in self.queue]
        matched_uuids: set = set()
        for kf in keyframes:
            if kf.node_id is None or kf.uuid in self._done:
                continue
            i = bisect.bisect_left(stamps, kf.stamp)
            best, best_dt = None, c.imu_time_tolerance
            for j in (i - 1, i):
                if 0 <= j < len(self.queue):
                    dt = abs(self.queue[j].stamp - kf.stamp)
                    if dt <= best_dt:
                        best, best_dt = self.queue[j], dt
            if best is None:
                continue
            bq = self.base_T_imu[3:7]
            quat_base = se3np.quat_mul(bq, np.asarray(best.quat, np.float32))
            acc_base = se3np.quat_rotate(bq, np.asarray(best.acc, np.float32))
            # attach to the keyframe for persistence (keyframe.cpp:97-104)
            kf.orientation = quat_base
            kf.acceleration = acc_base
            if c.enable_imu_orientation:
                info = np.eye(3) / (c.imu_orientation_edge_stddev ** 2)
                db.graph.add_se3_prior_quat_edge(
                    kf.node_id, quat_base, info,
                    kernel=c.imu_orientation_edge_robust_kernel)
            if c.enable_imu_acceleration:
                norm = np.linalg.norm(acc_base)
                if norm > 1e-6:
                    info = np.eye(3) / (c.imu_acceleration_edge_stddev ** 2)
                    db.graph.add_se3_prior_vec_edge(
                        kf.node_id, [0.0, 0.0, 1.0], acc_base / norm, info,
                        kernel=c.imu_acceleration_edge_robust_kernel)
            matched_uuids.add(kf.uuid)
            updated = True
        self._done |= matched_uuids
        if keyframes:
            newest = max(k.stamp for k in keyframes)
            self.queue = [s for s in self.queue
                          if s.stamp > newest - c.imu_time_tolerance]
        return updated


class FloorCoeffsProcessor:
    """floor_coeffs_processor.cpp: floor planes -> EdgeSE3Plane.

    Lazily creates ONE global fixed plane node z=0 (:68-71) and ties each
    stamp-matched keyframe to it with the locally-measured floor plane.
    """

    def __init__(self, cfg: FloorCoeffsConfig):
        self.cfg = cfg
        self.queue: List[FloorCoeffs] = []
        self.plane_node_id: Optional[int] = None

    def add_coeffs(self, fc: FloorCoeffs) -> None:
        self.queue.append(fc)

    def flush(self, db: GraphDatabase, keyframes: Sequence[KeyFrame],
              stamp_tolerance: float = 1e-4) -> bool:
        if not self.cfg.enable_floor_coeffs or not self.queue:
            return False
        updated = False
        by_stamp: Dict[float, KeyFrame] = {}
        for kf in keyframes:
            if kf.node_id is not None:
                by_stamp[round(kf.stamp, 6)] = kf
        remaining = []
        for fc in self.queue:
            kf = by_stamp.get(round(fc.stamp, 6))
            if kf is None:
                remaining.append(fc)
                continue
            if kf.floor_coeffs is not None:
                continue
            if self.plane_node_id is None:
                self.plane_node_id = db.graph.add_plane_node(
                    [0.0, 0.0, 1.0, 0.0], fixed=True)
            info = np.eye(3) / (self.cfg.floor_edge_stddev ** 2)
            db.graph.add_se3_plane_edge(
                kf.node_id, self.plane_node_id, fc.coeffs, info,
                kernel=self.cfg.floor_edge_robust_kernel)
            kf.floor_coeffs = np.asarray(fc.coeffs)
            updated = True
        self.queue = remaining
        return updated
