"""The port's front end (prefilter -> fused GICP odometry) against the JAX
package's, and the fused odometry's behaviour, on the small world of
tests/test_odometry_fused.py with RADIUS outlier removal on.

Tolerances and why:
- With the source covariances shared (the port's `make_source` fed the
  JAX package's covariances), the odometry state machine is held tightly:
  identical keyframe flags, poses within 1e-4 m and 1e-4 on quaternion
  components over 12 frames (float32 Gauss-Newton in two libraries).
- End to end, each package computes its own covariances. Both form them
  from raw float32 moments, M2/n - mean mean^T, whose cancellation at
  ~30 m leaves ~1e-4 of rounding noise that the two packages round
  differently; a neighbourhood of 3-4 nearly collinear points takes its
  normal from that noise, and GICP weights it 1000:1. One such point
  among ~800 moves a solve by up to ~1 cm, and the odometry chain
  carries the offset on. So the end-to-end test holds identical keyframe
  flags, RADIUS masks within 3 points a frame, poses within 2.5 cm /
  0.01 rad, and ATE within 1 cm of the reference's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import PrefilterConfig as JPrefilterConfig
from mrg_slam_tpu.config import RegistrationConfig as JRegistrationConfig
from mrg_slam_tpu.config import (
    ScanMatchingOdometryConfig as JScanMatchingOdometryConfig)
from mrg_slam_tpu.models import odometry_fused as jfused
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.ops.prefilter import prefilter as jprefilter

from mrg_slam_tpu_torch.convert import carry_from_numpy, config_from_fields
from mrg_slam_tpu_torch.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu_torch.models import odometry_fused as fused
from mrg_slam_tpu_torch.ops import registration as reg
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.ops.covariance import GICPCloud
from mrg_slam_tpu_torch.ops.prefilter import prefilter
from mrg_slam_tpu_torch.utils.metrics import ate_rmse

from test_torch_multirobot import one_thread  # noqa: F401 (a fixture)

FRAMES = 12
JCFG = JScanMatchingOdometryConfig(
    keyframe_delta_translation=2.0,
    registration=JRegistrationConfig(
        reg_transformation_epsilon=1e-3, reg_maximum_iterations=32,
        reg_covariance_mode="radius", reg_covariance_radius=1.0))
JPRE = JPrefilterConfig(downsample_resolution=0.4,
                        capacity_filtered_points=1024,
                        outlier_removal_method="RADIUS", radius_radius=1.0,
                        radius_min_neighbors=2)
CFG = config_from_fields(dataclasses.asdict(JCFG))
PRE = config_from_fields(dataclasses.asdict(JPRE))


@pytest.fixture(scope="module")
def world():
    w = SyntheticWorld.build(seed=9, extent=30.0, n_ground=20000,
                             max_points_per_scan=4096, noise=0.02)
    traj = circle_trajectory(FRAMES, radius=12.0, laps=0.15)
    return traj, [w.scan(p, seed=i) for i, p in enumerate(traj)]


@pytest.fixture(scope="module")
def jax_run(world):
    traj, scans = world
    clouds = [jprefilter(JCloud.from_array(s, 4096), JPRE) for s in scans]
    pts = jnp.stack([c.points for c in clouds])
    masks = jnp.stack([c.mask for c in clouds])
    carry0 = jfused.init_carry(1024)
    _, outs = jfused.run_batch(JCFG, carry0, pts, masks,
                               jnp.arange(FRAMES, dtype=jnp.float32) * 0.1)
    return dict(pts=np.array(pts), masks=np.array(masks),
                carry0={k: np.asarray(v)
                        for k, v in carry0._asdict().items()},
                pose=np.asarray(outs.pose),
                kf=np.asarray(outs.is_new_keyframe))


@pytest.fixture(scope="module")
def port_frames(world):
    _, scans = world
    clouds = [prefilter(PointCloud.from_array(s, 4096, device="cpu"), PRE)
              for s in scans]
    return (torch.stack([c.points for c in clouds]),
            torch.stack([c.mask for c in clouds]))


def _stamps():
    return torch.arange(FRAMES, dtype=torch.float32) * 0.1


def _check_poses(got, want, tol_t, tol_q):
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=tol_t)
    # quaternions up to sign
    sign = np.sign((got[:, 3:] * want[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(got[:, 3:] * sign, want[:, 3:], rtol=0,
                               atol=tol_q)


def test_slice_matches_jax(world, jax_run, port_frames):
    traj, _ = world
    pts, masks = port_frames
    assert (masks.numpy() != jax_run["masks"]).sum(1).max() <= 3
    carry = carry_from_numpy(jax_run["carry0"], device="cpu")
    _, outs = fused.run_batch(CFG, carry, pts, masks, _stamps())
    np.testing.assert_array_equal(outs.is_new_keyframe.numpy(),
                                  jax_run["kf"])
    assert jax_run["kf"].sum() >= 3
    pose = outs.pose.numpy()
    _check_poses(pose, jax_run["pose"], 2.5e-2, 1e-2)
    assert abs(ate_rmse(pose[:, :3], traj[:, :3])
               - ate_rmse(jax_run["pose"][:, :3], traj[:, :3])) < 0.01


def test_slice_matches_jax_with_shared_covariances(jax_run, monkeypatch):
    def jax_covs(cloud, params):
        covs = np.stack([np.asarray(jreg.make_source(
            JCloud(jnp.asarray(p), jnp.asarray(m)), JCFG.registration).covs)
            for p, m in zip(cloud.points.numpy(), cloud.mask.numpy())])
        return GICPCloud(cloud.points, cloud.mask, torch.from_numpy(covs))

    monkeypatch.setattr(fused.reg, "make_source", jax_covs)
    carry = carry_from_numpy(jax_run["carry0"], device="cpu")
    _, outs = fused.run_batch(CFG, carry, torch.from_numpy(jax_run["pts"]),
                              torch.from_numpy(jax_run["masks"]), _stamps())
    np.testing.assert_array_equal(outs.is_new_keyframe.numpy(),
                                  jax_run["kf"])
    _check_poses(outs.pose.numpy(), jax_run["pose"], 1e-4, 1e-4)


def test_batch_matches_stepwise(port_frames):
    pts, masks = port_frames
    carry = fused.init_carry(pts.shape[1], device="cpu")
    step = []
    for i in range(FRAMES):
        carry, out = fused.odometry_step(CFG, carry, pts[i], masks[i],
                                         _stamps()[i])
        step.append(out.pose)
    _, outs = fused.run_batch(CFG, fused.init_carry(pts.shape[1],
                                                    device="cpu"),
                              pts, masks, _stamps())
    np.testing.assert_allclose(outs.pose.numpy(), torch.stack(step).numpy(),
                               atol=1e-5)


def test_no_inlier_keeps_last_and_recovers(world, port_frames):
    """A scan with zero correspondences keeps the last relative pose (no
    jump, no constant-velocity death spiral) and the next good scan
    re-locks (odometry_fused.py keep-last)."""
    traj, _ = world
    pts, masks = port_frames
    carry = fused.init_carry(pts.shape[1], device="cpu")
    poses = []
    for i in range(FRAMES):
        p = pts[5] + 1000.0 if i == 5 else pts[i]
        carry, out = fused.odometry_step(CFG, carry, p, masks[i],
                                         _stamps()[i])
        poses.append(out.pose.numpy())
        if i == 5:
            assert not bool(out.converged)
            assert int(out.num_inliers) == 0
    est = np.stack(poses)
    steps = np.linalg.norm(np.diff(est[:, :3], axis=0), axis=1)
    assert steps[4] < 1e-3, steps
    assert steps.max() < 3.0, steps
    assert ate_rmse(est[6:, :3], traj[6:, :3]) < 1.0


def test_jump_rejection_forces_reacceptance(port_frames):
    """With transform thresholding an over-large relative pose is rejected
    (keep-last) until max_consecutive_rejections forces re-acceptance."""
    pts, masks = port_frames
    cfg = dataclasses.replace(CFG, enable_transform_thresholding=True,
                              max_acceptable_translation=0.05,
                              max_acceptable_angle=0.05,
                              max_consecutive_rejections=3)
    carry = fused.init_carry(pts.shape[1], device="cpu")
    carry, _ = fused.odometry_step(cfg, carry, pts[0], masks[0], 0.0)
    carry, out1 = fused.odometry_step(cfg, carry, pts[1], masks[1], 0.1)
    assert np.linalg.norm(out1.pose.numpy()[:3]) < 0.05
    assert int(carry.rejections) == 1
    for i in (2, 3, 4):
        carry, out = fused.odometry_step(cfg, carry, pts[i], masks[i],
                                         0.1 * i)
    assert np.linalg.norm(out.pose.numpy()[:3]) > 0.5


def test_covs_equal_make_source(port_frames):
    """OdomStepOut.covs are the scan's own make_source covariances (the
    covariance_compatible contract the back end relies on)."""
    pts, masks = port_frames
    carry = fused.init_carry(pts.shape[1], device="cpu")
    _, outs = fused.run_batch(CFG, carry, pts[:4], masks[:4], _stamps()[:4])
    assert outs.covs.shape == (4, pts.shape[1], 3, 3)
    r = CFG.registration
    assert reg.covariance_compatible(r, r)
    want = reg.make_source(PointCloud(pts[2], masks[2]), r)
    np.testing.assert_allclose(outs.covs[2].numpy(), want.covs.numpy(),
                               atol=1e-5)
    assert not reg.covariance_compatible(
        r, dataclasses.replace(r, reg_covariance_radius=2.0))
    assert not reg.covariance_compatible(
        r, dataclasses.replace(r, registration_method="NDT"))
