"""SE(3) / SO(3) math on 7-vector poses, in torch.

Same conventions as the JAX package's utils/se3.py:

- a pose maps local to world coordinates, ``x_w = R @ x_l + t``;
- it is stored as ``[tx, ty, tz, qw, qx, qy, qz]`` (w-first unit quaternion);
- twists are ``[rho, theta]`` and ``pose_exp`` uses the closed form with
  the SO(3) left Jacobian.

Small-angle branches use Taylor forms selected with `torch.where` on safe
inputs, so every function is branch-free and batches over leading dims.
"""

from __future__ import annotations

import torch

from . import profiling

# below 1e-2 rad the trig forms lose float32 precision to cancellation,
# while the dropped Taylor terms are O(theta^4) ~ 1e-10
_EPS = 1e-2


# -- quaternions (w-first) ---------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion q (broadcasting leading dims)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w >= 0), branch-free Shepperd:
    all four candidates are formed and the largest pivot is selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = torch.clamp(1.0 + tr, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    sw = torch.sqrt(qw2 + 1e-24) * 2.0
    cand_w = torch.stack([qw2 / 2.0 * (2.0 / sw), (m21 - m12) / sw,
                          (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = torch.sqrt(qx2 + 1e-24) * 2.0
    cand_x = torch.stack([(m21 - m12) / sx, qx2 / 2.0 * (2.0 / sx),
                          (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = torch.sqrt(qy2 + 1e-24) * 2.0
    cand_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy,
                          qy2 / 2.0 * (2.0 / sy), (m12 + m21) / sy], dim=-1)
    sz = torch.sqrt(qz2 + 1e-24) * 2.0
    cand_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                          (m12 + m21) / sz, qz2 / 2.0 * (2.0 / sz)], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


# -- SO(3) --------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zeros = torch.zeros_like(x)
    return torch.stack([zeros, -z, y, z, zeros, -x, -y, x, zeros],
                       dim=-1).reshape(v.shape[:-1] + (3, 3))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> rotation matrix (Rodrigues, Taylor near 0)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS ** 2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    W = skew(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w), the V matrix of the SE(3) exponential."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS ** 2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    W = skew(w)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (2 log q), with the JAX
    package's Taylor form near 0."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # w >= 0, theta in [0, pi]
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v2 = torch.sum(q[..., 1:4] * q[..., 1:4], dim=-1)
    small = v2 < _EPS ** 2
    v2_safe = torch.where(small, torch.ones_like(v2), v2)
    vnorm = torch.sqrt(v2_safe)
    main = 2.0 * torch.atan2(vnorm, w) / vnorm
    w_safe = torch.clamp(w, min=0.5)
    taylor = 2.0 / w_safe * (1.0 - v2 / (3.0 * w_safe * w_safe))
    scale = torch.where(small, taylor, main)
    return q[..., 1:4] * scale[..., None]


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """J_l(w)^-1 = I - W/2 + k W^2."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS ** 2
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    k = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - (theta * torch.sin(theta))
         / (2.0 * (1.0 - torch.cos(theta)))) / theta2_safe)
    W = skew(w)
    return _eye_like(W) - 0.5 * W + k[..., None, None] * (W @ W)


# -- 7-vector poses -----------------------------------------------------------

def pose_identity(device=None, dtype=torch.float32) -> torch.Tensor:
    p = torch.zeros(7, dtype=dtype, device=device)
    # the scalar reaches the card in a copy from pageable host memory,
    # which waits for the stream
    with profiling.span("read.pose_identity"):
        p[3] = 1.0
    return p


def pose_rotation(p: torch.Tensor) -> torch.Tensor:
    return quat_to_mat(p[..., 3:7])


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b: apply b first then a (matrix product T_a @ T_b)."""
    qa, qb = a[..., 3:7], b[..., 3:7]
    t = a[..., 0:3] + quat_rotate(qa, b[..., 0:3])
    q = quat_normalize(quat_mul(qa, qb))
    return torch.cat([t, q], dim=-1)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    qinv = quat_conjugate(p[..., 3:7])
    return torch.cat([-quat_rotate(qinv, p[..., 0:3]), qinv], dim=-1)


def pose_apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Transform points x (..., 3) by pose p."""
    return quat_rotate(p[..., 3:7], x) + p[..., 0:3]


def pose_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative pose a^-1 ∘ b (the g2o EdgeSE3 measurement convention)."""
    return pose_compose(pose_inverse(a), b)


def pose_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [rho, theta] -> 7-vector pose, t = J_l(theta) @ rho."""
    rho, w = xi[..., 0:3], xi[..., 3:6]
    R = so3_exp(w)
    t = (so3_left_jacobian(w) @ rho[..., None])[..., 0]
    return torch.cat([t, mat_to_quat(R)], dim=-1)


def pose_log(p: torch.Tensor) -> torch.Tensor:
    """7-vector pose -> twist [rho, theta]; the rotation goes through
    mat_to_quat(quat_to_mat(q)), as the JAX package's se3_log does."""
    w = quat_log(mat_to_quat(pose_rotation(p)))
    rho = (so3_left_jacobian_inv(w) @ p[..., 0:3, None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def pose_error(meas: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """EdgeSE3 residual log(meas^-1 a^-1 b) as a 6-twist."""
    return pose_log(pose_compose(pose_inverse(meas), pose_between(a, b)))


def pose_retract(p: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction p ∘ exp(xi) (the optimizer's chart)."""
    return pose_compose(p, pose_exp(xi))


def rotation_angle(q_or_R: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in radians from a quaternion or a matrix."""
    if q_or_R.shape[-1] == 4:
        w = torch.abs(torch.clamp(q_or_R[..., 0], -1.0, 1.0))
        return 2.0 * torch.arccos(w)
    tr = q_or_R.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
