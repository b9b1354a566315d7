"""Point-cloud registration (ICP / GICP / VGICP / NDT) as Gauss-Newton
over weighted correspondences.

Counterpart of the JAX package's ops/registration.py:

    minimize  sum_i  r_i^T W_i r_i,     r_i = q_i - T p_i

with method-specific correspondences and weights:

- ICP:   q the 1-NN target point (csrc/nn.cu on the card), W = I;
- GICP (SMALL_GICP, FAST_GICP, GICP, GICP_OMP): q the 1-NN point,
  W = (C_q + R C_p R^T)^-1;
- VGICP (FAST_VGICP, VGICP): q the mean of the source point's voxel in
  the target's Gaussian voxel map (ops/gaussian_voxel.py),
  W = (C_vox + R C_p R^T)^-1;
- NDT (NDT, NDT_OMP): q the voxel mean, W = C_vox^-1 times Magnusson's
  per-correspondence weight d2 exp(-d2/2 r^T W r) (pclomp's P2D score),
  no source covariances.

Jacobian convention: right perturbation T <- T * exp(xi),
J = [-R, R skew(p)].

The JAX package runs the iterations in one `lax.while_loop`; here they are
a Python loop that stops once the solve has converged (or stalled, or lost
every correspondence with the stall exit on). Reading that flag is one host
sync per Gauss-Newton iteration.

The back end's pair program (`align_pairs_packed`) runs B (target, source)
pairs as rows of one batched Gauss-Newton, each row with its own budget
and exits, where the JAX package maps `_align_impl` over the rows with
`vmap`. `align_pairs_voxel_packed` is the same program for voxel
targets, whose fitness pass still searches the raw target clouds.
`align_rows` runs the odometry solves of R co-hosted robots the same
way, one row each. The single-row path above stays as the single-robot
front end runs it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import RegistrationConfig
from ..utils import se3
from . import knn
from .cloud import PointCloud
from .covariance import (GICPCloud, estimate_covariances,
                         estimate_covariances_radius, inv3x3)
from .gaussian_voxel import GaussianVoxelMap, build_gaussian_voxel_map, lookup
from .stats_kernel import radius_sq

VOXEL_METHODS = ("FAST_VGICP", "VGICP", "NDT", "NDT_OMP")


class RegistrationResult(NamedTuple):
    pose: torch.Tensor         # (7,) final estimate
    converged: torch.Tensor    # bool: epsilon criteria met within the budget
    iterations: torch.Tensor   # int32 Gauss-Newton iterations run
    error: torch.Tensor        # mean weighted (Mahalanobis) error per inlier
    num_inliers: torch.Tensor  # int32 gated correspondences at the solution
    hessian: torch.Tensor      # (6, 6) Gauss-Newton Hessian at the solution


class RegistrationTarget(NamedTuple):
    """Registration target: the dense GICP cloud or the voxel map."""

    gicp: Optional[GICPCloud] = None
    voxels: Optional[GaussianVoxelMap] = None


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
    return estimate_covariances(cloud,
                                k=params.reg_correspondence_randomness)


def _identity_covs(cloud: PointCloud) -> GICPCloud:
    eye = torch.eye(3, dtype=cloud.points.dtype, device=cloud.points.device)
    return GICPCloud(cloud.points, cloud.mask,
                     eye.expand(cloud.points.shape[:-1] + (3, 3)))


def make_target(cloud: PointCloud, params: RegistrationConfig,
                voxel_capacity: int = 16384) -> RegistrationTarget:
    """Preprocess a target cloud for the configured method: covariances
    for the GICP family, a Gaussian voxel map of at most `voxel_capacity`
    voxels (cells of at least 4 points for NDT, 1 for VGICP) for the
    voxel family."""
    m = params.registration_method
    if is_gicp_like(m):
        return RegistrationTarget(gicp=_covariances(cloud, params)
                                  if m != "ICP" else _identity_covs(cloud))
    if m in VOXEL_METHODS:
        return RegistrationTarget(voxels=build_gaussian_voxel_map(
            cloud, params.reg_resolution, capacity=voxel_capacity,
            min_points=4 if m in ("NDT", "NDT_OMP") else 1))
    raise ValueError(f"unknown registration method {m}")


def make_source(cloud: PointCloud, params: RegistrationConfig) -> GICPCloud:
    """Preprocess a source cloud (covariances for the GICP family)."""
    if params.registration_method in ("SMALL_GICP", "FAST_GICP", "GICP",
                                      "GICP_OMP", "FAST_VGICP", "VGICP"):
        return _covariances(cloud, params)
    return _identity_covs(cloud)


def hessian_ridge(device: torch.device) -> torch.Tensor:
    """1e-6 I (6, 6), added to H before the solve; a solve stage makes it
    once for all its Gauss-Newton iterations."""
    return 1e-6 * torch.eye(6, device=device)


def _use_source_covs(method: str) -> bool:
    return method not in ("ICP", "NDT", "NDT_OMP")


def _ndt_d2(params: RegistrationConfig) -> Optional[float]:
    """NDT's Gaussian-plus-uniform mixture constant d2 (Magnusson 2009,
    as pclomp's ndt_omp_impl.hpp computeDerivatives forms it), computed in
    float32 as the JAX package does; None for the other methods."""
    if params.registration_method not in ("NDT", "NDT_OMP"):
        return None
    f32 = np.float32
    out_ratio = f32(params.reg_ndt_outlier_ratio)
    res3 = f32(params.reg_resolution) ** 3
    c1 = f32(10.0) * (f32(1.0) - out_ratio)
    c2 = out_ratio / res3
    d3 = -np.log(c2)
    d1 = -np.log(c1 + c2) - d3
    return float(f32(-2.0) * np.log(
        (-np.log(c1 * np.exp(f32(-0.5)) + c2) - d3) / d1))


def _voxel_correspondences(params: RegistrationConfig, vox: GaussianVoxelMap,
                           p_world: torch.Tensor, src_mask: torch.Tensor):
    """The voxel branch, over any leading row axes: (q, C_q, valid), q the
    mean of the looked-up voxel, valid where a voxel was found within the
    correspondence distance."""
    idx, found = lookup(vox, p_world, src_mask, params.reg_resolution,
                        method=params.reg_nn_search_method)
    q = torch.gather(vox.means, -2, idx[..., None].expand(p_world.shape))
    Cq = torch.gather(vox.covs, -3, idx[..., None, None].expand(
        p_world.shape + (3,)))
    d2 = torch.sum((q - p_world) ** 2, dim=-1)
    gate = d2 <= radius_sq(params.reg_max_correspondence_distance)
    return q, Cq, src_mask & found & gate


def _weights(params: RegistrationConfig, Cq, R, src_covs, r, valid,
             ndt_d2):
    """Per-correspondence W (..., N, 3, 3), zero where not valid."""
    if _use_source_covs(params.registration_method):
        W = inv3x3(Cq + R @ src_covs @ R.transpose(-1, -2))
    else:
        W = inv3x3(Cq)
    w = valid.to(W.dtype)
    if ndt_d2 is not None:
        m = torch.einsum("...a,...ab,...b->...", r, W, r)
        w = w * ndt_d2 * torch.exp(-0.5 * ndt_d2 * m)
    return W * w[..., None, None]


def _correspondences(params: RegistrationConfig, p_world: torch.Tensor,
                     src_mask: torch.Tensor, target: RegistrationTarget
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q (N,3), C_q (N,3,3), valid (N,)) at the current source pose."""
    if target.voxels is not None:
        return _voxel_correspondences(params, target.voxels, p_world,
                                      src_mask)
    tg = target.gicp
    _, idx, valid = knn.nn_within(p_world, src_mask, tg.points, tg.mask,
                                  params.reg_max_correspondence_distance)
    if params.reg_use_reciprocal_correspondences:
        # mutual nearest neighbours only (pcl setUseReciprocalCorrespondences)
        _, idx_back = knn.nearest_neighbor(tg.points, p_world, src_mask,
                                           src_mask=tg.mask)
        mutual = idx_back[idx] == torch.arange(p_world.shape[0],
                                               device=idx.device)
        valid = valid & mutual
    return tg.points[idx], tg.covs[idx], valid


def _gn_step(params: RegistrationConfig, src: GICPCloud,
             tgt: RegistrationTarget, pose: torch.Tensor,
             ridge: torch.Tensor, ndt_d2: Optional[float] = None):
    """One linearization -> (xi, H, mean error, inliers)."""
    sp = src.points
    R = se3.pose_rotation(pose)
    p_world = se3.pose_apply(pose, sp)
    q, Cq, valid = _correspondences(params, p_world, src.mask, tgt)
    r = q - p_world
    W = _weights(params, Cq, R, src.covs, r, valid, ndt_d2)
    Rskew = R @ se3.skew(sp)
    J = torch.cat([-R.expand(Rskew.shape), Rskew], dim=-1)  # (N, 3, 6)
    WJ = W @ J
    H = torch.einsum("nai,naj->ij", J, WJ)
    b = torch.einsum("naj,na->j", WJ, r)
    err = torch.einsum("na,nab,nb->", r, W, r)
    n_in = valid.sum(dtype=torch.int32)
    # solve_ex: no singularity check, which would sync with the host
    xi = torch.linalg.solve_ex(H + ridge, -b).result
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
    ridge = hessian_ridge(dev)
    ndt_d2 = _ndt_d2(params)
    it = 0
    while it < budget:
        xi, H, err2, n_in = _gn_step(params, src, tgt, pose, ridge, ndt_d2)
        pose = se3.pose_retract(pose, xi)
        it += 1
        done = ((torch.linalg.vector_norm(xi[:3]) < eps)
                & (torch.linalg.vector_norm(xi[3:]) < eps))
        stop = done
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
            stop = done | (n_in == 0)
        err = err2
        if bool(stop):  # the one host sync of the iteration
            break
    return pose, it, done, err, n_in, H


def _align_impl(params: RegistrationConfig, source: GICPCloud,
                target: RegistrationTarget, init_pose: torch.Tensor,
                max_iters: int) -> RegistrationResult:
    """Register `source` onto `target` within `max_iters` iterations.

    With reg_coarse_stride > 1 the first reg_coarse_iterations run on
    stride-subsampled source and target clouds, and the rest of the budget
    (at least one iteration) polishes at full resolution. A voxel target
    stays whole in the coarse stage: its lookup costs a source point one
    search, so the strided source already cuts the stage's cost.
    """
    pose0 = init_pose.to(torch.float32)
    stride = int(params.reg_coarse_stride)
    if stride > 1:
        src_c = GICPCloud(source.points[::stride], source.mask[::stride],
                          source.covs[::stride])
        tgt_c = target
        if target.gicp is not None:
            tg = target.gicp
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


# ---------------------------------------------------------------------------
# the back end's pair program: B rows of one batched Gauss-Newton
# ---------------------------------------------------------------------------

class PairResults(NamedTuple):
    """Pair-program outputs, one row per requested pair."""

    pose: torch.Tensor           # (B, 7) final (initial, if max_iters = 0)
    converged: torch.Tensor      # (B,) bool
    iterations: torch.Tensor     # (B,) int32
    num_inliers: torch.Tensor    # (B,) int32
    fitness_inf: torch.Tensor    # (B,) mean NN sq-dist at `pose`, no gate
    fitness_range: torch.Tensor  # (B,) the same, gated to fitness_max_range


def _live_lanes(mask: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The source lanes a sweep computes: a row that is done (or padded)
    has none, so the nn kernel's blocks of that row leave at once. Its
    outputs are discarded as `vmap(while_loop)` discards a finished row's,
    so this changes no result (tests/test_torch_backend.py)."""
    return mask & active[:, None]


def _gn_rows(params: RegistrationConfig, src: GICPCloud, tgt,
             pose: torch.Tensor, active: torch.Tensor,
             ridge: torch.Tensor, ndt_d2: Optional[float] = None):
    """One linearization of every row -> (xi (B, 6), H (B, 6, 6),
    mean error (B,), inliers (B,)); `_gn_step` over a batch of rows.
    `tgt` is the rows' GICP clouds or their voxel maps."""
    sp = src.points
    R = se3.pose_rotation(pose)[:, None]  # (B, 1, 3, 3)
    p_world = se3.pose_apply(pose[:, None, :], sp)
    sm = _live_lanes(src.mask, active)
    if isinstance(tgt, GaussianVoxelMap):
        q, Cq, valid = _voxel_correspondences(params, tgt, p_world, sm)
    else:
        _, idx, valid = knn.nn_within(p_world, sm, tgt.points, tgt.mask,
                                      params.reg_max_correspondence_distance)
        if params.reg_use_reciprocal_correspondences:
            _, idx_back = knn.nearest_neighbor(tgt.points, p_world, sm,
                                               src_mask=tgt.mask)
            lanes = torch.arange(sp.shape[1], device=idx.device)
            valid = valid & (torch.gather(idx_back, 1, idx) == lanes)
        q = torch.gather(tgt.points, 1, idx[..., None].expand(-1, -1, 3))
        Cq = torch.gather(tgt.covs, 1,
                          idx[..., None, None].expand(-1, -1, 3, 3))
    r = q - p_world
    W = _weights(params, Cq, R, src.covs, r, valid, ndt_d2)
    Rskew = R @ se3.skew(sp)
    J = torch.cat([-R.expand(Rskew.shape), Rskew], dim=-1)  # (B, N, 3, 6)
    WJ = W @ J
    H = torch.einsum("bnai,bnaj->bij", J, WJ)
    b = torch.einsum("bnaj,bna->bj", WJ, r)
    err = torch.einsum("bna,bnac,bnc->b", r, W, r)
    n_in = valid.sum(-1, dtype=torch.int32)
    xi = torch.linalg.solve_ex(H + ridge, -b).result
    return xi, H, err / torch.clamp(n_in, min=1), n_in


def _run_rows(params: RegistrationConfig, src: GICPCloud, tgt,
              pose: torch.Tensor, budget: torch.Tensor, go: bool):
    """Batched Gauss-Newton from `pose` (B, 7), row b for at most
    budget[b] iterations (an int32 tensor on the device; `go` says on the
    host whether any is positive), with `_run_stage`'s exits per row. A
    row that has finished freezes: its pose, iterations, flags, error,
    inliers and H stay as they were, as `vmap` over a `while_loop` leaves
    them. The one host read of a sweep is whether any row is active."""
    dev = pose.device
    nb = pose.shape[0]
    eps = params.reg_transformation_epsilon
    stall_eps = params.reg_stall_epsilon
    it = torch.zeros(nb, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    dead = torch.zeros_like(done)
    stall = torch.zeros_like(it)
    err = torch.full((nb,), float("inf"), device=dev)
    n_in = torch.zeros_like(it)
    H = torch.zeros(nb, 6, 6, device=dev)
    ridge = hessian_ridge(dev)
    ndt_d2 = _ndt_d2(params)
    active = budget > 0
    while go:
        xi, H2, err2, n2 = _gn_rows(params, src, tgt, pose, active, ridge,
                                    ndt_d2)
        new_pose = se3.pose_retract(pose, xi)
        conv = ((torch.linalg.vector_norm(xi[:, :3], dim=-1) < eps)
                & (torch.linalg.vector_norm(xi[:, 3:], dim=-1) < eps))
        improve = torch.where(torch.isfinite(err),
                              (err - err2) / torch.clamp(err, min=1e-12),
                              torch.full_like(err, float("inf")))
        stall2 = torch.where(improve < stall_eps, stall + 1,
                             torch.zeros_like(stall))
        if stall_eps > 0:
            conv = conv | ((stall2 >= 2) & (n2 > 0))
            dead2 = n2 == 0
        else:
            dead2 = torch.zeros_like(dead)
        a = active
        pose = torch.where(a[:, None], new_pose, pose)
        it = it + a.to(torch.int32)
        done = torch.where(a, conv, done)
        dead = torch.where(a, dead2, dead)
        stall = torch.where(a, stall2, stall)
        err = torch.where(a, err2, err)
        n_in = torch.where(a, n2, n_in)
        H = torch.where(a[:, None, None], H2, H)
        active = (it < budget) & ~done & ~dead
        go = bool(active.any())  # the one host read of the sweep
    return pose, it, done, err, n_in, H


def _strided(c, stride: int):
    """Rows' clouds subsampled by `stride`; a voxel map stays whole."""
    if isinstance(c, GaussianVoxelMap):
        return c
    return GICPCloud(*(x[:, ::stride].contiguous() for x in c))


def align_rows(params: RegistrationConfig, source: GICPCloud,
               target, init_pose: torch.Tensor,
               max_iters: int) -> RegistrationResult:
    """`_align_impl` over R rows at once: row r registers source[r] onto
    target[r] from init_pose[r] (R, 7) within `max_iters` iterations, with
    the same coarse stage (budget min(reg_coarse_iterations,
    max(max_iters - 1, 0)) on stride-subsampled rows) and fine stage. Both
    stages run through `_run_rows`, so a row keeps `_run_stage`'s exits
    and freezes once it has finished, and each sweep launches nn once for
    every row still active (a voxel target, a GaussianVoxelMap with a
    leading R axis, looks its voxels up instead). The fields of the result
    stack along R.

    Row r equals `_align_impl` on row r alone up to float32 rounding: the
    batched products sum in another order (tests/test_torch_multirobot.py).
    """
    dev = init_pose.device
    pose = init_pose.to(torch.float32)
    rows = pose.shape[0]
    stride = int(params.reg_coarse_stride)
    budget_c = (min(params.reg_coarse_iterations, max(max_iters - 1, 0))
                if stride > 1 else 0)
    budget_f = max(max_iters - budget_c, 0)
    iters = torch.zeros(rows, dtype=torch.int32, device=dev)
    if budget_c > 0:
        pose, iters, *_ = _run_rows(
            params, _strided(source, stride), _strided(target, stride), pose,
            torch.full((rows,), budget_c, dtype=torch.int32, device=dev),
            True)
    pose, it_f, done, err, n_in, H = _run_rows(
        params, source, target, pose,
        torch.full((rows,), budget_f, dtype=torch.int32, device=dev),
        budget_f > 0)
    return RegistrationResult(pose=pose, converged=done & (n_in > 0),
                              iterations=iters + it_f, error=err,
                              num_inliers=n_in, hessian=H)


def _fitness_rows(moved: torch.Tensor, src_mask: torch.Tensor,
                  tgt_points: torch.Tensor, tgt_mask: torch.Tensor,
                  fr: torch.Tensor):
    """Both fitness flavours from one NN pass: the mean NN squared
    distance of the valid sources, ungated and gated to fr per row (inf
    where no source counts)."""
    d2, _ = knn.nearest_neighbor(moved, tgt_points, tgt_mask, src_mask)
    ok = src_mask & torch.isfinite(d2)
    inf = torch.full(d2.shape[:1], float("inf"), device=d2.device)
    out = []
    for sel in (ok, ok & (d2 <= (fr * fr)[:, None])):
        n = sel.sum(-1, dtype=torch.int32)
        total = torch.where(sel, d2, torch.zeros_like(d2)).sum(-1)
        out.append(torch.where(n > 0, total / torch.clamp(n, min=1), inf))
    return out


def _pairs_program(params: RegistrationConfig, tgt, tgt_points, tgt_mask,
                   src: GICPCloud, init_poses, max_iters,
                   fitness_max_range) -> torch.Tensor:
    """The rows of a pair bucket: `tgt` the stacked GICP clouds or voxel
    maps the Gauss-Newton registers against, (tgt_points, tgt_mask) the
    raw target clouds the fitness pass searches."""
    dev = src.points.device
    mi = np.asarray(max_iters, np.int32)
    stride = int(params.reg_coarse_stride)
    budget_c = (np.minimum(np.int32(params.reg_coarse_iterations),
                           np.maximum(mi - 1, 0)) if stride > 1
                else np.zeros_like(mi))
    budget_f = np.maximum(mi - budget_c, 0)
    # the rows' inputs reach the device in one copy
    host = np.concatenate([np.asarray(init_poses, np.float32).reshape(-1, 7),
                           np.stack([budget_c, budget_f], 1),
                           np.asarray(fitness_max_range,
                                      np.float32)[:, None]], 1)
    rows = torch.from_numpy(host.astype(np.float32)).to(dev)
    pose, fr = rows[:, :7], rows[:, 9]
    iters = torch.zeros(len(mi), dtype=torch.int32, device=dev)
    if stride > 1:
        pose, iters, *_ = _run_rows(params, _strided(src, stride),
                                    _strided(tgt, stride), pose,
                                    rows[:, 7].to(torch.int32),
                                    bool((budget_c > 0).any()))
    pose, it_f, done, _, n_in, _ = _run_rows(
        params, src, tgt, pose, rows[:, 8].to(torch.int32),
        bool((budget_f > 0).any()))
    iters = iters + it_f
    moved = se3.pose_apply(pose[:, None, :], src.points)
    fit_inf, fit_r = _fitness_rows(moved, src.mask, tgt_points, tgt_mask,
                                   fr)
    res = PairResults(pose=pose, converged=done & (n_in > 0),
                      iterations=iters, num_inliers=n_in,
                      fitness_inf=fit_inf, fitness_range=fit_r)
    return torch.cat([res.pose] + [v.to(torch.float32)[:, None]
                                   for v in res[1:]], dim=1)


def align_pairs_packed(params: RegistrationConfig, tgts, srcs, init_poses,
                       max_iters, fitness_max_range) -> torch.Tensor:
    """The back end's pair program: every cloud pair of a tick as a row.

    `tgts`/`srcs` are length-B sequences of per-keyframe `GICPCloud`s of
    one capacity, on one device; `init_poses` (B, 7), `max_iters` (B,)
    ints and `fitness_max_range` (B,) floats are host arrays. Row b runs
    the Gauss-Newton from init_poses[b] for at most max_iters[b]
    iterations (0: evaluate only), coarse-to-fine as `_align_impl` does
    (its coarse budget min(reg_coarse_iterations, max(mi - 1, 0))), then
    takes both fitness flavours from one NN pass against the raw target
    (getFitnessScore searches the target cloud whatever the method).

    Returns one (B, 12) float32 tensor on the device, so the host reads a
    bucket back at once:

        row = [pose(7) | converged | iterations | num_inliers |
               fitness_inf | fitness_range]
    """
    tgt = GICPCloud(*(torch.stack(x) for x in zip(*tgts)))
    src = GICPCloud(*(torch.stack(x) for x in zip(*srcs)))
    return _pairs_program(params, tgt, tgt.points, tgt.mask, src,
                          init_poses, max_iters, fitness_max_range)


def align_pairs_voxel_packed(params: RegistrationConfig, tgt_maps,
                             tgt_clouds, srcs, init_poses, max_iters,
                             fitness_max_range) -> torch.Tensor:
    """`align_pairs_packed` for the voxel family (VGICP, NDT): `tgt_maps`
    are the rows' `GaussianVoxelMap`s (of one capacity: the caller pads
    them), `tgt_clouds` the matching raw `PointCloud`s, which the fitness
    pass searches with nn, `srcs` the rows' `GICPCloud`s (identity
    covariances for NDT). The same packed (B, 12) one-read contract."""
    vox = GaussianVoxelMap(*(torch.stack(x) for x in zip(*tgt_maps)))
    src = GICPCloud(*(torch.stack(x) for x in zip(*srcs)))
    return _pairs_program(params, vox,
                          torch.stack([c.points for c in tgt_clouds]),
                          torch.stack([c.mask for c in tgt_clouds]), src,
                          init_poses, max_iters, fitness_max_range)
