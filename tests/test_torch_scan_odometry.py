"""The port's per-frame `ScanMatchingOdometry` against the JAX package's, on
the same prefiltered clouds of a small synthetic world (512 lanes a scan):
a circle with keyframe switches, a straight line, the MSF and
robot-odometry initial guesses, keep-last on a scan with no overlap, and
the transform-jump rejection with its forced re-acceptance. The JAX
package's nearest neighbours run with exact differences throughout, as
the port's do (ROADMAP.md §3 B1).

Tolerances and why:
- With the covariances shared (the port's `make_source`/`make_target` fed
  the JAX package's), the state machine is held tightly: keyframe flags
  equal, poses within 2e-4 m and 2e-4 on quaternion components over 30
  frames (float32 Gauss-Newton in two libraries, and the initial guess
  composed in numpy here, in jnp there).
- End to end, each package forms its own radius covariances from raw
  float32 moments, whose ~1e-4 of rounding noise tilts the normal of a
  near-degenerate neighbourhood (ROADMAP.md §3, "Covariance noise"). That
  moves a solve by up to ~1 cm, and the chain carries the offset on, a few
  cm after 30 frames. So whole runs hold equal keyframe flags and ATE
  within 1 cm of the JAX package's, as tests/test_torch_odometry.py holds
  the fused front end; the short runs of 3-6 frames (the guesses,
  keep-last, rejection) hold poses within 2.5 cm / 0.01 on quaternion
  components, and the JAX package's own bounds (tests/test_odometry.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu.config import PrefilterConfig as JPrefilterConfig
from mrg_slam_tpu.config import RegistrationConfig as JRegistrationConfig
from mrg_slam_tpu.config import (
    ScanMatchingOdometryConfig as JScanMatchingOdometryConfig)
from mrg_slam_tpu.io.synthetic import (SyntheticWorld, circle_trajectory,
                                       straight_trajectory)
from mrg_slam_tpu.models.odometry import \
    ScanMatchingOdometry as JScanMatchingOdometry
from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.ops.prefilter import prefilter as jprefilter

from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.models import odometry as todo
from mrg_slam_tpu_torch.ops.cloud import PointCloud
from mrg_slam_tpu_torch.ops.covariance import GICPCloud
from mrg_slam_tpu_torch.utils.metrics import ate_rmse

from test_torch_multirobot import exact_sqdist, one_thread  # noqa: F401

CAP = 512
JCFG = JScanMatchingOdometryConfig(
    keyframe_delta_translation=2.0,
    registration=JRegistrationConfig(reg_transformation_epsilon=1e-3,
                                     reg_maximum_iterations=32,
                                     reg_correspondence_randomness=10))
JPRE = JPrefilterConfig(downsample_resolution=0.6, capacity_raw_points=2048,
                        capacity_filtered_points=CAP,
                        outlier_removal_method="NONE")


@pytest.fixture(scope="module", autouse=True)
def exact_jax_nn_module():
    """Every JAX run of this module with the exact nearest neighbours of
    the Pallas kernel, as the port computes them (ROADMAP.md §3 B1: the
    JAX package's CPU expansion moves correspondences near the gate)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_chunk_sqdist", exact_sqdist)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _tcfg(jcfg):
    return config_from_fields(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def world():
    return SyntheticWorld.build(seed=9, extent=30.0, n_ground=20000,
                                max_points_per_scan=2048, noise=0.01)


def _clouds(world, traj, seed0=0, pre=JPRE):
    """The JAX package's prefiltered clouds as numpy (points, mask)."""
    out = []
    for i, p in enumerate(traj):
        c = jprefilter(JCloud.from_array(world.scan(p, seed=seed0 + i),
                                         pre.capacity_raw_points), pre)
        out.append((np.array(c.points), np.array(c.mask)))
    return out


def _run_jax(cfg, clouds, feed=None):
    odom = JScanMatchingOdometry(cfg)
    outs = []
    for i, (p, m) in enumerate(clouds):
        if feed:
            feed(odom, i)
        outs.append(odom.step(JCloud(jnp.asarray(p), jnp.asarray(m)),
                              stamp=i * 0.1))
    return outs


def _run_port(cfg, clouds, feed=None):
    odom = todo.ScanMatchingOdometry(_tcfg(cfg))
    outs = []
    for i, (p, m) in enumerate(clouds):
        if feed:
            feed(odom, i)
        outs.append(odom.step(PointCloud(torch.from_numpy(p),
                                         torch.from_numpy(m)),
                              stamp=i * 0.1))
    return outs


def _check(port, ref, tol_t, tol_q):
    _same_keyframes(port, ref)
    got = np.stack([o.pose for o in port])
    want = np.stack([np.asarray(o.pose) for o in ref])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=tol_t)
    sign = np.sign((got[:, 3:] * want[:, 3:]).sum(-1, keepdims=True))
    np.testing.assert_allclose(got[:, 3:] * sign, want[:, 3:], rtol=0,
                               atol=tol_q)
    return got


def _share_jax_covs(monkeypatch):
    """The port's make_source/make_target with the JAX package's
    covariances of the same cloud."""
    def covs(cloud, params):
        jc = JCloud(jnp.asarray(cloud.points.numpy()),
                    jnp.asarray(cloud.mask.numpy()))
        c = np.array(jreg.make_source(jc, JCFG.registration).covs)
        return GICPCloud(cloud.points, cloud.mask, torch.from_numpy(c))

    monkeypatch.setattr(todo.reg, "make_source", covs)
    monkeypatch.setattr(todo.reg, "make_target", lambda cloud, params:
                        todo.reg.RegistrationTarget(gicp=covs(cloud, params)))


@pytest.fixture(scope="module")
def circle(world):
    traj = circle_trajectory(30, radius=12.0, laps=0.4)
    clouds = _clouds(world, traj)
    return traj, clouds, _run_jax(JCFG, clouds)


def _ate(outs, traj):
    return ate_rmse(np.stack([np.asarray(o.pose) for o in outs])[:, :3],
                    traj[:, :3])


def _same_keyframes(port, ref):
    assert [o.is_new_keyframe for o in port] == \
        [bool(o.is_new_keyframe) for o in ref]


def test_circle_matches_jax_with_shared_covariances(circle, monkeypatch):
    traj, clouds, ref = circle
    _share_jax_covs(monkeypatch)
    port = _run_port(JCFG, clouds)
    _check(port, ref, 2e-4, 2e-4)
    assert sum(o.is_new_keyframe for o in port) >= 5
    st = port[-1].status
    assert st.has_converged and 0.5 < st.inlier_fraction <= 1.0
    assert st.prediction_labels == ()


def test_circle_matches_jax(circle):
    traj, clouds, ref = circle
    port = _run_port(JCFG, clouds)
    _same_keyframes(port, ref)
    assert abs(_ate(port, traj) - _ate(ref, traj)) < 0.01
    assert _ate(port, traj) < 0.25


def test_straight_line_matches_jax(world):
    traj = straight_trajectory(16, speed=0.5)
    clouds = _clouds(world, traj, seed0=50)
    port = _run_port(JCFG, clouds)
    ref = _run_jax(JCFG, clouds)
    _same_keyframes(port, ref)
    assert abs(_ate(port, traj) - _ate(ref, traj)) < 0.01
    assert _ate(port, traj) < 0.15


def _jump_clouds(world, seed0):
    """3 m steps, at tests/test_odometry.py's width (2048 filtered lanes):
    a scan 6 m from its keyframe needs the denser cloud."""
    return _clouds(world, straight_trajectory(3, speed=3.0), seed0,
                   dataclasses.replace(JPRE, downsample_resolution=0.4,
                                       capacity_raw_points=4096,
                                       capacity_filtered_points=2048))


def test_msf_guess_matches_jax(world):
    """enable_imu_frontend: the MSF pose delta seeds the registration
    (scan_matching_odometry_component.cpp:210-223); a 3 m jump is beyond
    reg_max_correspondence_distance, so only the MSF delta recovers it."""
    cfg = dataclasses.replace(JCFG, enable_imu_frontend=True,
                              keyframe_delta_translation=10.0)
    traj = straight_trajectory(3, speed=3.0)

    def feed(odom, i):
        odom.msf_pose_callback(i * 0.1 - 0.001,
                               np.asarray(traj[max(i - 1, 0)], np.float32),
                               after_update=True)
        odom.msf_pose_callback(i * 0.1, np.asarray(traj[i], np.float32),
                               after_update=False)

    clouds = _jump_clouds(world, 100)
    port = _run_port(cfg, clouds, feed)
    got = _check(port, _run_jax(cfg, clouds, feed), 2.5e-2, 1e-2)
    assert [o.status.prediction_labels for o in port[1:]] == [("imu",)] * 2
    np.testing.assert_allclose(np.linalg.norm(np.diff(got[:, :3], axis=0),
                                              axis=1), 3.0, atol=0.2)


def test_robot_odometry_guess_matches_jax(world):
    """enable_robot_odometry_init_guess: deltas of a secondary odometry
    stream seed the registration (:225-263)."""
    cfg = dataclasses.replace(JCFG, enable_robot_odometry_init_guess=True,
                              keyframe_delta_translation=10.0)
    traj = straight_trajectory(3, speed=3.0)

    def feed(odom, i):
        odom.robot_odom_callback(np.asarray(traj[i], np.float32))

    clouds = _jump_clouds(world, 200)
    port = _run_port(cfg, clouds, feed)
    got = _check(port, _run_jax(cfg, clouds, feed), 2.5e-2, 1e-2)
    assert [o.status.prediction_labels for o in port[1:]] == \
        [("odometry",)] * 2
    np.testing.assert_allclose(np.linalg.norm(np.diff(got[:, :3], axis=0),
                                              axis=1), 3.0, atol=0.2)


def test_zero_overlap_keeps_last_pose(circle):
    """A scan with no overlap with the keyframe (every correspondence
    lost) leaves the estimate where it was, as the JAX package does
    (keep-last, :270-273)."""
    _, clouds, _ = circle
    rng = np.random.default_rng(0)
    far = np.full((CAP, 3), 1e6, np.float32)
    far[:256] = rng.uniform(-1, 1, (256, 3)) + [1e4, 1e4, 0.0]
    fmask = np.arange(CAP) < 256
    seq = [clouds[0], clouds[0], (far, fmask), clouds[1]]
    ref = _run_jax(JCFG, seq)
    port = _run_port(JCFG, seq)
    assert not port[2].status.has_converged
    assert not ref[2].status.has_converged
    np.testing.assert_allclose(port[2].pose, port[1].pose, atol=1e-6)
    _check(port, ref, 2.5e-2, 1e-2)


def test_jump_rejection_matches_jax(circle):
    """With transform thresholding an over-large relative pose is rejected
    (keep-last) until max_consecutive_rejections forces re-acceptance."""
    _, clouds, _ = circle
    cfg = dataclasses.replace(JCFG, enable_transform_thresholding=True,
                              max_acceptable_translation=0.05,
                              max_acceptable_angle=0.05,
                              max_consecutive_rejections=3)
    port = _run_port(cfg, clouds[:6])
    got = _check(port, _run_jax(cfg, clouds[:6]), 2.5e-2, 1e-2)
    # frames 1 and 2 rejected (held at the keyframe), frame 3 forced in
    assert np.abs(got[1:3, :3]).max() < 1e-6
    assert np.linalg.norm(got[3, :3]) > 0.5
