"""GICP-family registration as Gauss-Newton over weighted correspondences.

Counterpart of the GICP branch of the JAX package's ops/registration.py:

    minimize  sum_i  r_i^T W_i r_i,     r_i = q_i - T p_i

with q the 1-NN target point (csrc/nn.cu on the card) and
W = (C_q + R C_p R^T)^-1 (identity source covariances for ICP). Jacobian
convention: right perturbation T <- T * exp(xi), J = [-R, R skew(p)].

The JAX package runs the iterations in one `lax.while_loop`; here they are
a Python loop that stops once the solve has converged (or stalled, or lost
every correspondence with the stall exit on). Reading that flag is one host
sync per Gauss-Newton iteration. The voxel-target family (VGICP, NDT) is
not ported yet (ROADMAP.md queue 1 item 11).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RegistrationConfig
from ..utils import se3
from . import knn
from .cloud import PointCloud
from .covariance import GICPCloud, estimate_covariances_radius, inv3x3

_VOXEL_LATER = ("is not ported yet: the voxel-target family waits for "
                "ROADMAP.md queue 1 item 11")


class RegistrationResult(NamedTuple):
    pose: torch.Tensor         # (7,) final estimate
    converged: torch.Tensor    # bool: epsilon criteria met within the budget
    iterations: torch.Tensor   # int32 Gauss-Newton iterations run
    error: torch.Tensor        # mean weighted (Mahalanobis) error per inlier
    num_inliers: torch.Tensor  # int32 gated correspondences at the solution
    hessian: torch.Tensor      # (6, 6) Gauss-Newton Hessian at the solution


class RegistrationTarget(NamedTuple):
    """Registration target; only the dense GICP cloud is ported."""

    gicp: Optional[GICPCloud] = None


def is_gicp_like(method: str) -> bool:
    return method in ("SMALL_GICP", "FAST_GICP", "GICP", "GICP_OMP", "ICP")


def covariance_compatible(a: RegistrationConfig,
                          b: RegistrationConfig) -> bool:
    """True when `make_source(cloud, a)` and `make_source(cloud, b)` yield
    identical covariances (the gate for handing the front end's per-scan
    covariances to the back end)."""
    ga, gb = is_gicp_like(a.registration_method), is_gicp_like(
        b.registration_method)
    if not (ga and gb):
        return False
    ia, ib = a.registration_method == "ICP", b.registration_method == "ICP"
    if ia != ib:
        return False
    if ia:
        return True  # both identity covariances
    if a.reg_covariance_mode != b.reg_covariance_mode:
        return False
    if a.reg_covariance_mode == "radius":
        return a.reg_covariance_radius == b.reg_covariance_radius
    return (a.reg_correspondence_randomness
            == b.reg_correspondence_randomness)


def _covariances(cloud: PointCloud, params: RegistrationConfig) -> GICPCloud:
    if params.reg_covariance_mode == "radius":
        return estimate_covariances_radius(
            cloud, radius=params.reg_covariance_radius)
    raise NotImplementedError(
        "kNN covariances (reg_covariance_mode='knn') are not ported yet: "
        "they wait for top-k knn; use reg_covariance_mode='radius'")


def _identity_covs(cloud: PointCloud) -> GICPCloud:
    eye = torch.eye(3, dtype=cloud.points.dtype, device=cloud.points.device)
    return GICPCloud(cloud.points, cloud.mask,
                     eye.expand(cloud.points.shape[:-1] + (3, 3)))


def make_target(cloud: PointCloud,
                params: RegistrationConfig) -> RegistrationTarget:
    """Preprocess a target cloud for the configured method."""
    m = params.registration_method
    if not is_gicp_like(m):
        raise NotImplementedError(f"registration method {m} {_VOXEL_LATER}")
    return RegistrationTarget(gicp=_covariances(cloud, params)
                              if m != "ICP" else _identity_covs(cloud))


def make_source(cloud: PointCloud, params: RegistrationConfig) -> GICPCloud:
    """Preprocess a source cloud (covariances for the GICP family)."""
    if params.registration_method in ("SMALL_GICP", "FAST_GICP", "GICP",
                                      "GICP_OMP", "FAST_VGICP", "VGICP"):
        return _covariances(cloud, params)
    return _identity_covs(cloud)


def _correspondences(params: RegistrationConfig, p_world: torch.Tensor,
                     src_mask: torch.Tensor, target: RegistrationTarget
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q (N,3), C_q (N,3,3), valid (N,)) at the current source pose."""
    tg = target.gicp
    _, idx, valid = knn.nn_within(p_world, src_mask, tg.points, tg.mask,
                                  params.reg_max_correspondence_distance)
    if params.reg_use_reciprocal_correspondences:
        # mutual nearest neighbours only (pcl setUseReciprocalCorrespondences)
        _, idx_back = knn.nearest_neighbor(tg.points, p_world, src_mask)
        mutual = idx_back[idx] == torch.arange(p_world.shape[0],
                                               device=idx.device)
        valid = valid & mutual
    return tg.points[idx], tg.covs[idx], valid


def _gn_step(params: RegistrationConfig, src: GICPCloud,
             tgt: RegistrationTarget, pose: torch.Tensor):
    """One linearization -> (xi, H, mean error, inliers)."""
    sp = src.points
    R = se3.pose_rotation(pose)
    p_world = se3.pose_apply(pose, sp)
    q, Cq, valid = _correspondences(params, p_world, src.mask, tgt)
    r = q - p_world
    if params.registration_method != "ICP":
        W = inv3x3(Cq + R @ src.covs @ R.T)
    else:
        W = inv3x3(Cq)
    W = W * valid.to(W.dtype)[:, None, None]
    Rskew = R @ se3.skew(sp)
    J = torch.cat([-R.expand(Rskew.shape), Rskew], dim=-1)  # (N, 3, 6)
    WJ = W @ J
    H = torch.einsum("nai,naj->ij", J, WJ)
    b = torch.einsum("naj,na->j", WJ, r)
    err = torch.einsum("na,nab,nb->", r, W, r)
    n_in = valid.sum(dtype=torch.int32)
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    # solve_ex: no singularity check, which would sync with the host
    xi = torch.linalg.solve_ex(H + 1e-6 * eye6, -b).result
    return xi, H, err / torch.clamp(n_in, min=1), n_in


def _run_stage(params: RegistrationConfig, src: GICPCloud,
               tgt: RegistrationTarget, pose: torch.Tensor, budget: int):
    """Gauss-Newton from `pose` for at most `budget` iterations."""
    dev = pose.device
    eps = params.reg_transformation_epsilon
    stall_eps = params.reg_stall_epsilon
    stall_on = stall_eps > 0
    # state made by fills, not host copies (each copy syncs the stream)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    err = torch.full((), float("inf"), device=dev)
    n_in = torch.zeros((), dtype=torch.int32, device=dev)
    H = torch.zeros((6, 6), device=dev)
    it = 0
    while it < budget:
        xi, H, err2, n_in = _gn_step(params, src, tgt, pose)
        pose = se3.pose_retract(pose, xi)
        it += 1
        done = ((torch.linalg.vector_norm(xi[:3]) < eps)
                & (torch.linalg.vector_norm(xi[3:]) < eps))
        dead = torch.zeros_like(done)
        if stall_on:
            # per-solve stall exit (registration.py:299-333 of the JAX
            # package): stalled with correspondences counts as converged,
            # no correspondences at all ends the solve unconverged
            improve = torch.where(torch.isfinite(err),
                                  (err - err2) / torch.clamp(err, min=1e-12),
                                  torch.full_like(err, float("inf")))
            stall = torch.where(improve < stall_eps, stall + 1,
                                torch.zeros_like(stall))
            done = done | ((stall >= 2) & (n_in > 0))
            dead = n_in == 0
        err = err2
        if bool(done | dead):  # the one host sync of the iteration
            break
    return pose, it, done, err, n_in, H


def _align_impl(params: RegistrationConfig, source: GICPCloud,
                target: RegistrationTarget, init_pose: torch.Tensor,
                max_iters: int) -> RegistrationResult:
    """Register `source` onto `target` within `max_iters` iterations.

    With reg_coarse_stride > 1 the first reg_coarse_iterations run on
    stride-subsampled source and target clouds, and the rest of the budget
    (at least one iteration) polishes at full resolution.
    """
    if not is_gicp_like(params.registration_method) or target.gicp is None:
        raise NotImplementedError(
            f"registration method {params.registration_method} "
            f"{_VOXEL_LATER}")
    pose0 = init_pose.to(torch.float32)
    stride = int(params.reg_coarse_stride)
    if stride > 1:
        tg = target.gicp
        src_c = GICPCloud(source.points[::stride], source.mask[::stride],
                          source.covs[::stride])
        tgt_c = RegistrationTarget(gicp=GICPCloud(
            tg.points[::stride], tg.mask[::stride], tg.covs[::stride]))
        budget_c = min(params.reg_coarse_iterations, max(max_iters - 1, 0))
        pose_c, it_c, *_ = _run_stage(params, src_c, tgt_c, pose0, budget_c)
        pose, it_f, done, err, n_in, H = _run_stage(
            params, source, target, pose_c, max(max_iters - budget_c, 0))
        iters = it_c + it_f
    else:
        pose, iters, done, err, n_in, H = _run_stage(params, source, target,
                                                     pose0, max_iters)
    # hasConverged() semantics: the update criterion was met within the
    # budget AND correspondences exist at the solution
    return RegistrationResult(
        pose=pose, converged=done & (n_in > 0),
        iterations=torch.full((), iters, dtype=torch.int32,
                              device=pose.device),
        error=err, num_inliers=n_in, hessian=H)


def align(params: RegistrationConfig, source: GICPCloud,
          target: RegistrationTarget,
          init_pose: torch.Tensor) -> RegistrationResult:
    """Register `source` onto `target` from `init_pose` (7-vector), with
    the reference's reg_* parameters (registrations.cpp:34-43)."""
    return _align_impl(params, source, target, init_pose,
                       params.reg_maximum_iterations)
