"""Pure-numpy SE(3) pose helpers for the back end's host bookkeeping.

A copy of the JAX package's utils/se3np.py, so the port needs nothing of
that package. utils/se3.py is the torch implementation the device code
uses; the back end's host bookkeeping (keyframe admission, odom->map
updates, loop-candidate guesses, consistency cycles) composes a handful of
7-vector poses per tick, and a device round trip for each would cost a
stream sync. Pose layout matches se3.py: [x y z, qw qx qy qz].
"""

from __future__ import annotations

import numpy as np


def pose_identity() -> np.ndarray:
    return np.asarray([0, 0, 0, 1, 0, 0, 0], np.float32)


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / max(float(np.linalg.norm(q)), 1e-12)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.asarray([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], a.dtype)


def quat_conjugate(q: np.ndarray) -> np.ndarray:
    return np.asarray([q[0], -q[1], -q[2], -q[3]], q.dtype)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Rotate vector(s) v (3,) or (N,3) by unit quaternion q (wxyz)."""
    w, x, y, z = q
    u = np.asarray([x, y, z], v.dtype)
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def pose_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    t = a[:3] + quat_rotate(a[3:7], b[:3])
    q = quat_normalize(quat_mul(a[3:7], b[3:7]))
    return np.concatenate([t, q]).astype(np.float32)


def pose_inverse(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float32)
    qc = quat_conjugate(p[3:7])
    t = -quat_rotate(qc, p[:3])
    return np.concatenate([t, qc]).astype(np.float32)


def pose_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a^-1 * b."""
    return pose_compose(pose_inverse(a), b)


def pose_apply(p: np.ndarray, x: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float32)
    return quat_rotate(p[3:7], np.asarray(x, np.float32)) + p[:3]


def rotation_angle(q: np.ndarray) -> float:
    """Rotation magnitude of a unit quaternion (wxyz), in radians."""
    q = quat_normalize(np.asarray(q, np.float64))
    w = min(abs(float(q[0])), 1.0)
    return 2.0 * float(np.arccos(w))


def rpy_to_quat(roll: float, pitch: float, yaw: float) -> np.ndarray:
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return np.asarray([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy], np.float32)


def pose_log(p: np.ndarray) -> np.ndarray:
    """7-vector pose -> 6-twist [rho, omega] (numpy mirror of se3.pose_log).
    Host tools (pipeline/inspect.py's chi2 breakdown) evaluate a handful
    of residuals, so a device round trip for each would cost more than it
    computes."""
    p = np.asarray(p, np.float64)
    q = p[3:7] / max(float(np.linalg.norm(p[3:7])), 1e-12)
    w, v = q[0], q[1:4]
    s = float(np.linalg.norm(v))
    theta = 2.0 * float(np.arctan2(s, w))
    if theta > np.pi:
        theta -= 2.0 * np.pi
    axis = v / s if s > 1e-12 else np.zeros(3)
    omega = theta * axis
    th2 = theta * theta
    W = np.array([[0, -omega[2], omega[1]],
                  [omega[2], 0, -omega[0]],
                  [-omega[1], omega[0], 0]], np.float64)
    if abs(theta) < 1e-5:
        Vinv = np.eye(3) - 0.5 * W + (1.0 / 12.0) * (W @ W)
    else:
        Vinv = (np.eye(3) - 0.5 * W
                + (1.0 / th2 - (1.0 + np.cos(theta))
                   / (2.0 * theta * np.sin(theta))) * (W @ W))
    rho = Vinv @ p[:3]
    return np.concatenate([rho, omega]).astype(np.float32)


def pose_error(meas: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """EdgeSE3 residual log(meas^-1 * a^-1 * b) (se3.pose_error mirror)."""
    return pose_log(pose_compose(pose_inverse(np.asarray(meas, np.float32)),
                                 pose_between(a, b)))
