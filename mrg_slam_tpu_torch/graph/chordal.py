"""Chordal initialization of a pose graph.

Counterpart of the JAX package's graph/chordal.py. A cold-started graph (a
restored or merged map, the solver section's noisy rings) hands LM
rotations far outside its quadratic basin. Chordal initialization
(Martinec & Pajdla 2007; Carlone et al., ICRA 2015) relaxes SO(3) to
R^3x3, solves one linear least-squares problem for every rotation,
projects the result back onto SO(3), then solves the translations, which
are linear given the rotations. Both solves are matrix-free CG whose
operator is two scatters over the SE3 edge table.

Only SE3 edges drive it. Fixed nodes (or, with none, the first valid
node) anchor both solves by a strong tie to their current estimates;
invalid nodes and nodes without an edge are tied weakly, so no gauge
freedom reaches CG. The CG loops read whether they have converged every
solve.CG_CHECK_EVERY iterations; a converged loop's state is frozen, so
the result is that of a loop that stopped at once.
"""

from __future__ import annotations

import torch

from ..utils import se3
from .solve import CG_CHECK_EVERY, _segment_sum
from .types import PoseGraphData

_ANCHOR_WEIGHT = 1.0e4  # soft equality tie of the anchored nodes
_CG_ITERS = 128
_CG_TOL = 1.0e-6


def _cg(apply_A, b: torch.Tensor, x0: torch.Tensor, iters: int,
        tol: float) -> torch.Tensor:
    """Plain conjugate gradient on a flat operator, from x0, while
    ||r|| > tol ||b|| and fewer than `iters` iterations ran."""
    r = b - apply_A(x0)
    bnorm = torch.clamp(torch.sqrt(torch.sum(b * b)), min=1e-30)
    x, p, rs = x0, r, torch.sum(r * r)
    for i in range(iters):
        live = torch.sqrt(rs) > tol * bnorm
        if i % CG_CHECK_EVERY == 0 and not bool(live):
            break
        Ap = apply_A(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        rs_new = torch.sum(r_new * r_new)
        p_new = r_new + (rs_new / torch.clamp(rs, min=1e-30)) * p
        x = torch.where(live, x_new, x)
        r = torch.where(live, r_new, r)
        p = torch.where(live, p_new, p)
        rs = torch.where(live, rs_new, rs)
    return x


def _project_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotations to near-orthogonal (..., 3, 3): eight Newton polar
    steps R <- (R + R^-T) / 2, with R^-T from the columns' cross
    products. A degenerate input (|det| <= 1e-6) becomes the identity and
    an improper one (det < 0) is negated first."""
    d = torch.linalg.det(M)[..., None, None]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    M = torch.where(d.abs() > 1e-6, M, eye)
    R = torch.where(d < 0, -M, M)
    for _ in range(8):
        c0, c1, c2 = R[..., 0], R[..., 1], R[..., 2]
        x12 = torch.linalg.cross(c1, c2, dim=-1)
        det = torch.sum(c0 * x12, dim=-1)[..., None, None]
        adj = torch.stack([x12, torch.linalg.cross(c2, c0, dim=-1),
                           torch.linalg.cross(c0, c1, dim=-1)], dim=-1)
        R = 0.5 * (R + adj / torch.where(det.abs() > 1e-20, det,
                                         torch.ones_like(det)))
    return R


def chordal_init(g: PoseGraphData) -> torch.Tensor:
    """(N, 7) poses re-initialized by chordal relaxation. Invalid and
    anchored nodes keep their estimates exactly; the caller hands the
    result to LM."""
    e = g.se3
    n = g.poses.shape[0]
    w = e.mask.to(g.poses.dtype)
    fi, ti = e.from_idx.long(), e.to_idx.long()

    valid = g.node_mask
    any_fixed = torch.any(g.node_fixed & valid)
    first = torch.argmax(valid.to(torch.int32))
    anchor = torch.where(any_fixed, g.node_fixed & valid,
                         torch.arange(n, device=valid.device) == first)
    # nodes with no valid edge and no anchor would make the operator
    # singular; tie them (weakly) to their estimate as well
    deg = _segment_sum(w, fi, n) + _segment_sum(w, ti, n)
    aw = (anchor.to(w.dtype) * _ANCHOR_WEIGHT
          + (valid & (deg == 0)).to(w.dtype) + (~valid).to(w.dtype))

    R_meas = se3.quat_to_mat(e.meas[:, 3:7])         # (E, 3, 3)
    R0 = se3.quat_to_mat(g.poses[:, 3:7])             # (N, 3, 3)
    t0 = g.poses[:, :3]

    # rotations, over Y_i = R_i^T: the edge residual Y_to - R_e^T Y_from
    # (from R_to = R_from R_e); the normal operator scatters it back
    Y0 = R0.transpose(-1, -2)
    R_measT = R_meas.transpose(-1, -2)

    def apply_rot(Yf):
        Y = Yf.view(n, 3, 3)
        r = (Y[ti] - R_measT @ Y[fi]) * w[:, None, None]
        out = _segment_sum(r, ti, n) + _segment_sum(-(R_meas @ r), fi, n)
        return (out + aw[:, None, None] * Y).reshape(-1)

    Y = _cg(apply_rot, (aw[:, None, None] * Y0).reshape(-1),
            Y0.reshape(-1), _CG_ITERS, _CG_TOL)
    R = _project_so3(Y.view(n, 3, 3).transpose(-1, -2))

    # translations, linear given the rotations: residual t_to - t_from -
    # R_from t_e
    d = (R[fi] @ e.meas[:, :3, None])[..., 0] * w[:, None]

    def apply_tr(Tf):
        T = Tf.view(n, 3)
        r = (T[ti] - T[fi]) * w[:, None]
        out = _segment_sum(r, ti, n) + _segment_sum(-r, fi, n)
        return (out + aw[:, None] * T).reshape(-1)

    b_tr = _segment_sum(d, ti, n) + _segment_sum(-d, fi, n) + aw[:, None] * t0
    t = _cg(apply_tr, b_tr.reshape(-1), t0.reshape(-1), _CG_ITERS,
            _CG_TOL).view(n, 3)

    poses = torch.cat([t, se3.mat_to_quat(R)], dim=1)
    keep = (anchor | ~valid)[:, None]
    return torch.where(keep, g.poses, poses)
