"""Frame-to-keyframe scan-matching odometry with a device-resident carry.

Counterpart of the JAX package's models/odometry_fused.py. The carry holds
the keyframe target, the poses and the switch bookkeeping as tensors on the
card; the keyframe switch (scan_matching_odometry_component.cpp:326-339),
keep-last on a failed registration and the transform-jump rejection are
`torch.where` selects, not host branches. For the GICP family the would-be
keyframe target is the current source (same cloud, same covariances), so
switching keyframes costs nothing.

`run_batch` takes a block of frames: it computes the block's source
covariances in one batched pass, then steps frame by frame (the JAX
package's `lax.scan` becomes a Python loop). The only host syncs are the
Gauss-Newton loop's exit checks (ops/registration.py). `run_batch_multi`
steps R co-hosted robots' blocks together, one R-row solve a frame.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ..config import ScanMatchingOdometryConfig
from ..ops import registration as reg
from ..ops.cloud import PAD_VALUE, PointCloud
from ..ops.covariance import GICPCloud
from ..runtime import DeviceLike, resolve_device
from ..utils import se3


class OdomCarry(NamedTuple):
    target_points: torch.Tensor   # (P, 3) keyframe cloud
    target_mask: torch.Tensor     # (P,)
    target_covs: torch.Tensor     # (P, 3, 3)
    keyframe_pose: torch.Tensor   # (7,) odom frame
    keyframe_stamp: torch.Tensor  # f32
    prev_rel: torch.Tensor        # (7,) keyframe -> last scan
    last_delta: torch.Tensor      # (7,) scan-to-scan
    prev_pose: torch.Tensor       # (7,)
    initialized: torch.Tensor     # bool
    rejections: torch.Tensor      # int32 consecutive jump rejections


class OdomStepOut(NamedTuple):
    pose: torch.Tensor             # (7,)
    delta: torch.Tensor            # (7,)
    is_new_keyframe: torch.Tensor  # bool
    converged: torch.Tensor        # bool
    error: torch.Tensor            # f32
    num_inliers: torch.Tensor      # int32
    iterations: torch.Tensor       # int32 Gauss-Newton iterations
    covs: torch.Tensor             # (P, 3, 3) source GICP covariances


def init_carry(capacity: int, device: DeviceLike = None) -> OdomCarry:
    """Empty carry for clouds of `capacity` points, on the card unless
    `device` says otherwise."""
    dev = resolve_device(device)
    ident = se3.pose_identity(dev)
    return OdomCarry(
        target_points=torch.full((capacity, 3), PAD_VALUE, device=dev),
        target_mask=torch.zeros(capacity, dtype=torch.bool, device=dev),
        target_covs=torch.eye(3, device=dev).expand(capacity, 3, 3).clone(),
        keyframe_pose=ident, keyframe_stamp=torch.zeros((), device=dev),
        prev_rel=ident, last_delta=ident, prev_pose=ident,
        initialized=torch.zeros((), dtype=torch.bool, device=dev),
        rejections=torch.zeros((), dtype=torch.int32, device=dev))


def _step(cfg: ScanMatchingOdometryConfig, carry: OdomCarry,
          source: GICPCloud, stamp: torch.Tensor
          ) -> Tuple[OdomCarry, OdomStepOut]:
    params = cfg.registration
    _refuse_voxel(params)
    guess = se3.pose_compose(carry.prev_rel, carry.last_delta)
    target = reg.RegistrationTarget(gicp=GICPCloud(
        carry.target_points, carry.target_mask, carry.target_covs))
    result = reg._align_impl(params, source, target, guess,
                             params.reg_maximum_iterations)
    return _advance(cfg, carry, source, stamp, result)


def _refuse_voxel(params) -> None:
    """The fused front end carries the keyframe target as a GICP cloud,
    so it runs the GICP family only, as the JAX package's asserts
    (models/odometry_fused.py:100-102); the per-frame
    `ScanMatchingOdometry` runs the voxel family."""
    if not reg.is_gicp_like(params.registration_method):
        raise NotImplementedError(
            "fused odometry runs the GICP family (SMALL_GICP, FAST_GICP, "
            f"GICP, GICP_OMP, ICP), not {params.registration_method}: its "
            "carry holds a GICP target, as in the JAX package; use the "
            "per-frame ScanMatchingOdometry for VGICP and NDT")


def _advance(cfg: ScanMatchingOdometryConfig, carry: OdomCarry,
             source: GICPCloud, stamp: torch.Tensor,
             result: reg.RegistrationResult
             ) -> Tuple[OdomCarry, OdomStepOut]:
    """The state machine after a frame's solve, over any leading row axes
    (none for one robot, R for `run_batch_multi`): every select takes the
    row's own flags, so one row's keyframe switch leaves the others'."""
    ident = se3.pose_identity(carry.prev_rel.device)

    def sel(flag, a, b):  # per row: a where flag, else b
        lanes = max(a.ndim, b.ndim) - flag.ndim
        return torch.where(flag.reshape(flag.shape + (1,) * lanes), a, b)

    # keep-last on failure (scan_matching_odometry_component.cpp:270-273):
    # a solve that lost every correspondence returns a garbage running pose
    ok = (result.num_inliers > 0) & torch.isfinite(result.pose).all(-1)
    rel = sel(ok, result.pose, carry.prev_rel)

    # transform-jump rejection with forced re-acceptance after
    # max_consecutive_rejections (:278-315), as masked selects
    jd = se3.pose_between(carry.prev_rel, rel)
    jump = ((torch.linalg.vector_norm(jd[..., :3], dim=-1)
             > cfg.max_acceptable_translation)
            | (se3.rotation_angle(jd[..., 3:7]) > cfg.max_acceptable_angle))
    gate = jump & cfg.enable_transform_thresholding
    reject = gate & (carry.rejections < cfg.max_consecutive_rejections)
    rel = sel(reject, carry.prev_rel, rel)
    zero = torch.zeros_like(carry.rejections)
    rejections = torch.where(
        gate, torch.where(reject, carry.rejections + 1, zero), zero)

    pose = se3.pose_compose(carry.keyframe_pose, rel)
    delta = se3.pose_between(carry.prev_pose, pose)
    new_kf = ((torch.linalg.vector_norm(rel[..., :3], dim=-1)
               > cfg.keyframe_delta_translation)
              | (se3.rotation_angle(rel[..., 3:7]) > cfg.keyframe_delta_angle)
              | ((stamp - carry.keyframe_stamp) > cfg.keyframe_delta_time)
              | ~carry.initialized)

    # first frame: become the keyframe at identity with identity rel
    pose = sel(carry.initialized, pose, ident)
    delta = sel(carry.initialized, delta, ident)
    rel_out = sel(new_kf, ident, rel)

    carry2 = OdomCarry(
        target_points=sel(new_kf, source.points, carry.target_points),
        target_mask=sel(new_kf, source.mask, carry.target_mask),
        target_covs=sel(new_kf, source.covs, carry.target_covs),
        keyframe_pose=sel(new_kf, pose, carry.keyframe_pose),
        keyframe_stamp=sel(new_kf, stamp.to(torch.float32),
                           carry.keyframe_stamp),
        prev_rel=rel_out, last_delta=delta, prev_pose=pose,
        initialized=torch.ones_like(carry.initialized),
        rejections=rejections)
    out = OdomStepOut(pose=pose, delta=delta, is_new_keyframe=new_kf,
                      converged=ok, error=result.error,
                      num_inliers=result.num_inliers,
                      iterations=result.iterations, covs=source.covs)
    return carry2, out


def odometry_step(cfg: ScanMatchingOdometryConfig, carry: OdomCarry,
                  points: torch.Tensor, mask: torch.Tensor,
                  stamp: torch.Tensor) -> Tuple[OdomCarry, OdomStepOut]:
    """One frame-to-keyframe odometry step (GICP family)."""
    source = reg.make_source(PointCloud(points, mask), cfg.registration)
    return _step(cfg, carry, source, torch.as_tensor(stamp,
                                                     device=points.device))


def run_batch(cfg: ScanMatchingOdometryConfig, carry: OdomCarry,
              points: torch.Tensor, masks: torch.Tensor,
              stamps: torch.Tensor) -> Tuple[OdomCarry, OdomStepOut]:
    """Step through an (F, P, 3) frame block; outputs stack along F."""
    sources = reg.make_source(PointCloud(points, masks), cfg.registration)
    outs = []
    for f in range(points.shape[0]):
        src = GICPCloud(sources.points[f], sources.mask[f], sources.covs[f])
        carry, out = _step(cfg, carry, src, stamps[f])
        outs.append(out)
    return carry, OdomStepOut(*(torch.stack(v) for v in zip(*outs)))


def stack_carries(carries: Sequence[OdomCarry]) -> OdomCarry:
    """R robots' carries as one carry with a leading robot axis, e.g.
    `stack_carries([init_carry(P, dev) for _ in robots])`."""
    return OdomCarry(*(torch.stack(x) for x in zip(*carries)))


def unstack_carries(carries: OdomCarry) -> List[OdomCarry]:
    """The robots' carries of a robot-stacked carry, in row order."""
    return [OdomCarry(*(x[r] for x in carries))
            for r in range(carries.initialized.shape[0])]


def run_batch_multi(cfg: ScanMatchingOdometryConfig, carries: OdomCarry,
                    points: torch.Tensor, masks: torch.Tensor,
                    stamps: torch.Tensor) -> Tuple[OdomCarry, OdomStepOut]:
    """R robots' (F, P, 3) frame blocks, (R, F, P, 3) points, (R, F, P)
    masks and (R, F) stamps, as one batched stream.

    Counterpart of the JAX package's `run_batch_multi` (`vmap` over the
    robots of a `lax.scan` over frames): the R*F source covariances come
    from one pass of the moments kernel, then each frame index runs one
    R-row solve (`registration.align_rows`: one nn launch a sweep for all
    robots, as many sweeps as the slowest robot's Gauss-Newton needs) and
    the state machine with the row axis. The robots' chains stay
    independent; outputs stack as (R, F, ...).
    """
    _refuse_voxel(cfg.registration)
    n_r, n_f = points.shape[:2]
    flat = reg.make_source(PointCloud(points.flatten(0, 1),
                                      masks.flatten(0, 1)), cfg.registration)
    sources = GICPCloud(*(x.unflatten(0, (n_r, n_f)) for x in flat))
    outs = []
    for f in range(n_f):
        src = GICPCloud(*(x[:, f] for x in sources))
        guess = se3.pose_compose(carries.prev_rel, carries.last_delta)
        result = reg.align_rows(cfg.registration, src, GICPCloud(
            carries.target_points, carries.target_mask, carries.target_covs),
            guess, cfg.registration.reg_maximum_iterations)
        carries, out = _advance(cfg, carries, src, stamps[:, f], result)
        outs.append(out)
    return carries, OdomStepOut(*(torch.stack(v, dim=1) for v in zip(*outs)))
