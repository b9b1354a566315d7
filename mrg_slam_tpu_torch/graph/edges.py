"""Edge residuals and Jacobians of the SE3-SE3 family.

Counterpart of the SE3-SE3 part of the JAX package's graph/edges.py. The
residual is g2o's EdgeSE3, log(meas^-1 T_i^-1 T_j), linearized in the
right-multiplicative chart of both nodes (T <- T exp(xi)).

Jacobians in closed form. The JAX package takes them from `jax.jacfwd`
of the residual through the chart; that derivative is, exactly,

    J_to   =  Jr^-1(e)
    J_from = -Jr^-1(e) Ad(T_j^-1 T_i)

with e the residual, Jr^-1 the SE(3) right Jacobian inverse
(Jr^-1(e) = Jl^-1(-e), the left one with Barfoot's Q block) and Ad the
6x6 adjoint in rho-first order. They are formed in float64 from the
float32 residual and poses and rounded to float32 once, so they carry
no cancellation of the small-angle coefficients. (Forward-mode autodiff
with `torch.func` gives the same numbers but runs many times the ops of
this closed form, each a kernel launch on the card.)

The prior, SE3-plane, plane-prior and plane-plane families are not ported
yet (ROADMAP.md queue 1 item 12); graph/solve.py refuses a table that
holds such an edge.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import se3
from .types import SE3Edges

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
