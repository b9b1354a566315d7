"""Edge residuals and Jacobians of every edge family.

Counterpart of the JAX package's graph/edges.py. Residuals mirror the g2o
types the reference registers (graph_slam.cpp:33-42), linearized in the
right-multiplicative chart of an SE(3) node (T <- T exp(xi)) and the
tangent chart of a plane node (types.plane_retract):

- EdgeSE3:          log(meas^-1 T_i^-1 T_j)
- EdgeSE3PriorXYZ:  t - meas            (XY: zero z information)
- EdgeSE3PriorQuat: s q.vec - meas.vec, s = sign(q . meas) a constant
- EdgeSE3PriorVec:  R^T dir_world - measured_local
- EdgeSE3Plane:     [B(n_m)^T n_local, d_local - d_m]
- plane priors:     n - meas (NORMAL) or d - meas (DISTANCE), 4-padded
- plane-plane:      (b - a) - meas (IDENTITY), normal difference
                    (PARALLEL) or normal dot (PERPENDICULAR), 4-padded

Jacobians of the SE3-SE3 family in closed form. The JAX package takes
them from `jax.jacfwd` of the residual through the chart; that
derivative is, exactly,

    J_to   =  Jr^-1(e)
    J_from = -Jr^-1(e) Ad(T_j^-1 T_i)

with e the residual, Jr^-1 the SE(3) right Jacobian inverse
(Jr^-1(e) = Jl^-1(-e), the left one with Barfoot's Q block) and Ad the
6x6 adjoint in rho-first order. They are formed in float64 from the
float32 residual and poses and rounded to float32 once, so they carry
no cancellation of the small-angle coefficients. (Forward-mode autodiff
with `torch.func` gives the same numbers but runs many times the ops of
this closed form, each a kernel launch on the card.)

The other families' Jacobians are short closed forms, in float32, of
the same derivatives at the chart's origin: with q^ = q/|q|, a pose
moves by dt = R rho and dR = R [w]x; a plane's normal by B(n) delta[:2]
/ |n| (its basis is orthogonal to n) and its offset by delta[2]. So the
XYZ prior's is [R, 0], the quaternion prior's [0, s/2 (q^_w I +
[q^_v]x)], the vector prior's [0, [R^T dir]x]; the SE3-plane edge's are
derived in `plane_edge_terms`. Every row of a prior or plane-plane table
computes each of its type's residuals, and its type selects one, as the
JAX package's `jnp.select` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import se3
from .types import (PLANE_PLANE_IDENTITY, PLANE_PLANE_PARALLEL,
                    PLANE_PRIOR_NORMAL, PRIOR_QUAT, PRIOR_XYZ, PlaneEdges,
                    PlanePlaneEdges, PlanePriorEdges, PriorEdges, SE3Edges,
                    plane_basis)

_SMALL = 1e-2  # below this angle the coefficients take their Taylor forms


def _q_block(rho: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(rho, theta), the off-diagonal block of the SE(3) left
    Jacobian (float64)."""
    t2 = torch.sum(th * th, dim=-1)
    small = t2 < _SMALL ** 2
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    s, c = torch.sin(t), torch.cos(t)
    c1 = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - s) / (t2s * t))
    c2 = torch.where(small, 1.0 / 24.0 - t2 / 720.0,
                     (t2s + 2.0 * c - 2.0) / (2.0 * t2s * t2s))
    c3 = torch.where(small, 1.0 / 120.0 - t2 / 2520.0,
                     (2.0 * t - 3.0 * s + t * c) / (2.0 * t2s * t2s * t))
    P, W = se3.skew(rho), se3.skew(th)
    WP, PW = W @ P, P @ W
    WPW = WP @ W
    return (0.5 * P + c1[..., None, None] * (WP + PW + WPW)
            + c2[..., None, None] * (W @ WP + PW @ W - 3.0 * WPW)
            + c3[..., None, None] * (WPW @ W + W @ WPW))


def _jr_inv(e: torch.Tensor) -> torch.Tensor:
    """SE(3) right Jacobian inverse of twists e (..., 6), rho first."""
    rho, th = -e[..., :3], -e[..., 3:]
    Ji = se3.so3_left_jacobian_inv(th)
    off = -Ji @ _q_block(rho, th) @ Ji
    top = torch.cat([Ji, off], dim=-1)
    bot = torch.cat([torch.zeros_like(Ji), Ji], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _adjoint(p: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint of poses (..., 7), rho-first: [[R, t^ R], [0, R]]."""
    R = se3.pose_rotation(p)
    top = torch.cat([R, se3.skew(p[..., :3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_edge_terms(poses: torch.Tensor, edges: SE3Edges
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> r (E, 6), J_from (E, 6, 6), J_to (E, 6, 6)."""
    pi, pj = poses[edges.from_idx], poses[edges.to_idx]
    r = se3.pose_error(edges.meas, pi, pj)
    f64 = torch.float64
    jr_inv = _jr_inv(r.to(f64))
    ad = _adjoint(se3.pose_between(pj.to(f64), pi.to(f64)))
    return (r, (-jr_inv @ ad).to(poses.dtype), jr_inv.to(poses.dtype))


def _sel(ptype: torch.Tensor, code: int) -> torch.Tensor:
    return (ptype == code)[:, None, None]


def prior_edge_terms(poses: torch.Tensor, edges: PriorEdges
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> r (E, 3), J (E, 3, 6) of the unary SE3 priors."""
    p = poses[edges.node_idx]
    t, q = p[:, 0:3], se3.quat_normalize(p[:, 3:7])
    meas = edges.meas
    r_xyz = t - meas[:, 0:3]
    s = torch.sign(torch.sum(q * meas[:, 0:4], dim=-1) + 1e-12)[:, None]
    r_quat = s * q[:, 1:4] - meas[:, 1:4]
    u = se3.quat_rotate(se3.quat_conjugate(q), meas[:, 0:3])
    r_vec = u - meas[:, 3:6]
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    zero = torch.zeros_like(eye).expand(p.shape[0], 3, 3)
    j_xyz = torch.cat([se3.pose_rotation(p), zero], dim=-1)
    j_quat = torch.cat([zero, (0.5 * s)[..., None] * (
        q[:, 0, None, None] * eye + se3.skew(q[:, 1:4]))], dim=-1)
    j_vec = torch.cat([zero, se3.skew(u)], dim=-1)
    xyz, quat = _sel(edges.ptype, PRIOR_XYZ), _sel(edges.ptype, PRIOR_QUAT)
    r = torch.where(xyz[:, 0], r_xyz, torch.where(quat[:, 0], r_quat, r_vec))
    J = torch.where(xyz, j_xyz, torch.where(quat, j_quat, j_vec))
    return r, J


def _plane_chart(planes: torch.Tensor):
    """-> (unit normals (E, 3), d (E, 1), the normal's chart derivative
    B(n) / |n| (E, 3, 2))."""
    n = planes[:, 0:3]
    norm = torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                       min=1e-12)
    return n / norm, planes[:, 3:4], plane_basis(n) / norm[..., None]


def plane_edge_terms(poses: torch.Tensor, planes: torch.Tensor,
                     edges: PlaneEdges
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> r (E, 3), J_pose (E, 3, 6), J_plane (E, 3, 3).

    With n_l = R^T n and d_l = d + n . t: dn_l = [n_l]x w + R^T B dn,
    dd_l = n_l . rho + t^T B dn + dd, and r = [B_m^T n_l, d_l - d_m] in
    the measured normal's tangent basis B_m."""
    p = poses[edges.node_idx]
    t = p[:, 0:3]
    R = se3.quat_to_mat(se3.quat_normalize(p[:, 3:7]))
    n, d, Bn = _plane_chart(planes[edges.plane_idx])
    Bm_T = plane_basis(edges.meas[:, 0:3]).transpose(1, 2)   # (E, 2, 3)
    Rt = R.transpose(1, 2)
    n_l = (Rt @ n[..., None])[..., 0]
    d_l = d[:, 0] + torch.sum(n * t, dim=-1)
    r = torch.cat([(Bm_T @ n_l[..., None])[..., 0],
                   (d_l - edges.meas[:, 3])[:, None]], dim=-1)
    z3 = torch.zeros_like(t)
    J_pose = torch.cat([
        torch.cat([torch.zeros_like(Bm_T), Bm_T @ se3.skew(n_l)], dim=-1),
        torch.cat([n_l, z3], dim=-1)[:, None]], dim=1)
    one = torch.ones_like(d)
    J_plane = torch.cat([
        torch.cat([Bm_T @ Rt @ Bn, torch.zeros_like(Bm_T[..., :1])], dim=-1),
        torch.cat([(t[:, None] @ Bn)[:, 0], one], dim=-1)[:, None]], dim=1)
    return r, J_pose, J_plane


def _plane_jac(Bn: torch.Tensor) -> torch.Tensor:
    """(E, 4, 3) derivative of a plane's (n, d) in its chart."""
    e = Bn.shape[0]
    J = Bn.new_zeros((e, 4, 3))
    J[:, 0:3, 0:2] = Bn
    J[:, 3, 2] = 1.0
    return J


def plane_prior_terms(planes: torch.Tensor, edges: PlanePriorEdges
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> r (E, 4), J (E, 4, 3) of the plane priors."""
    n, d, Bn = _plane_chart(planes[edges.plane_idx])
    z = torch.zeros_like(d)
    r_normal = torch.cat([n - edges.meas[:, 0:3], z], dim=-1)
    r_dist = torch.cat([d - edges.meas[:, 0:1], z, z, z], dim=-1)
    J = _plane_jac(Bn)
    j_normal = J.clone()
    j_normal[:, 3] = 0.0
    j_dist = torch.zeros_like(J)
    j_dist[:, 0] = J[:, 3]
    normal = _sel(edges.ptype, PLANE_PRIOR_NORMAL)
    return (torch.where(normal[:, 0], r_normal, r_dist),
            torch.where(normal, j_normal, j_dist))


def plane_plane_terms(planes: torch.Tensor, edges: PlanePlaneEdges
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> r (E, 4), J_a (E, 4, 3), J_b (E, 4, 3) of the plane-plane
    edges, a the 'from' plane and b the 'to' plane."""
    na, da, Ba = _plane_chart(planes[edges.from_idx])
    nb, db, Bb = _plane_chart(planes[edges.to_idx])
    meas = edges.meas
    z = torch.zeros_like(da)
    r_ident = torch.cat([nb - na, db - da], dim=-1) - meas
    r_par = torch.cat([(nb - na) - meas[:, 0:3], z], dim=-1)
    r_perp = torch.cat([torch.sum(na * nb, dim=-1, keepdim=True)
                        - meas[:, 0:1], z, z, z], dim=-1)
    Ja, Jb = _plane_jac(Ba), _plane_jac(Bb)
    ja_par, jb_par = -Ja.clone(), Jb.clone()
    ja_par[:, 3] = 0.0
    jb_par[:, 3] = 0.0
    ja_perp, jb_perp = torch.zeros_like(Ja), torch.zeros_like(Jb)
    ja_perp[:, 0, 0:2] = (nb[:, None] @ Ba)[:, 0]
    jb_perp[:, 0, 0:2] = (na[:, None] @ Bb)[:, 0]
    ident = _sel(edges.ptype, PLANE_PLANE_IDENTITY)
    par = _sel(edges.ptype, PLANE_PLANE_PARALLEL)
    r = torch.where(ident[:, 0], r_ident,
                    torch.where(par[:, 0], r_par, r_perp))
    J_a = torch.where(ident, -Ja, torch.where(par, ja_par, ja_perp))
    J_b = torch.where(ident, Jb, torch.where(par, jb_par, jb_perp))
    return r, J_a, J_b


def transform_plane(pose: torch.Tensor, plane_world: torch.Tensor
                    ) -> torch.Tensor:
    """World plane (n, d), n.x + d = 0, in the frame of `pose`."""
    R = se3.pose_rotation(pose)
    n_l = (R.transpose(-1, -2) @ plane_world[..., 0:3, None])[..., 0]
    d_l = plane_world[..., 3] + torch.sum(plane_world[..., 0:3]
                                          * pose[..., 0:3], dim=-1)
    return torch.cat([n_l, d_l[..., None]], dim=-1)
