"""The port's replay harness (`Robot`, `replay`, `replay_fused`) against the
JAX package's `replay` on a small world: 30 frames of 1.1 laps, 4096 raw
-> 512 filtered points, a tick every 12 frames (the last block a ragged
6), loops on the revisit. The JAX package's nearest neighbours run with
exact differences, as the port's do (ROADMAP.md §3 B1), and per-tick
marginals are off on both sides (tests/test_torch_graph.py holds them;
compiling the JAX package's would cost this file seconds it does not
have). tests/test_torch_replay_fused.py holds the port's two paths to
each other.

Tolerances and why:
- `replay` with every covariance shared (the port's
  `registration._covariances`, through which odometry, keyframes and the
  pair program take theirs, fed the JAX package's of the same cloud): the
  same keyframes, the same loop pairs, map-frame poses within 1e-3 m and
  ATE within 1e-3 m (float32 solves in two libraries).
- `replay_fused` end to end, each package forming its own covariances,
  whose float32 rounding noise moves a solve by up to ~1 cm (ROADMAP.md
  §3, "Covariance noise"): the same keyframes and loops, ATE within 2 cm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrg_slam_tpu import config as jconfig
from mrg_slam_tpu.io.synthetic import SyntheticWorld, circle_trajectory
from mrg_slam_tpu.ops import knn as jknn
from mrg_slam_tpu.ops import registration as jreg
from mrg_slam_tpu.ops.cloud import PointCloud as JCloud
from mrg_slam_tpu.pipeline import replay as jreplay

from mrg_slam_tpu_torch import config as tconfig
from mrg_slam_tpu_torch.convert import config_from_fields
from mrg_slam_tpu_torch.ops import registration as treg
from mrg_slam_tpu_torch.ops.covariance import GICPCloud
from mrg_slam_tpu_torch.pipeline import replay as treplay
from mrg_slam_tpu_torch.utils.tum import load_tum

from test_torch_multirobot import exact_sqdist, one_thread  # noqa: F401

FRAMES, TICK = 30, 12
_REG = jconfig.RegistrationConfig(reg_transformation_epsilon=1e-3,
                                  reg_maximum_iterations=24,
                                  reg_correspondence_randomness=10)
JCFG = jconfig.EngineConfig(
    prefilter=jconfig.PrefilterConfig(downsample_resolution=0.5,
                                      capacity_raw_points=4096,
                                      capacity_filtered_points=512,
                                      distance_far_thresh=14.0,
                                      outlier_removal_method="NONE"),
    odometry=jconfig.ScanMatchingOdometryConfig(
        keyframe_delta_translation=2.0, registration=_REG),
    slam=jconfig.SlamConfig(
        own_name="f", multi_robot_names=("f",), keyframe_delta_trans=2.0,
        capacity_keyframes=64, capacity_edges=256,
        capacity_keyframe_points=512, registration=_REG,
        optimizer=jconfig.OptimizerConfig(solver_backend="dense",
                                          g2o_solver_num_iterations=64,
                                          per_tick_marginals="none"),
        loop=dataclasses.replace(jconfig.LoopClosureConfig(),
                                 capacity_candidates=4,
                                 fitness_score_max_range=2.0),
        robot_remove_points_radius=0.0))
CFG = config_from_fields(dataclasses.asdict(JCFG))


@pytest.fixture(scope="module")
def frames():
    world = SyntheticWorld.build(seed=13, extent=25.0, n_ground=15000,
                                 max_points_per_scan=4096, noise=0.02)
    traj = circle_trajectory(FRAMES, radius=8.0, laps=1.1)
    return traj, [(i * 0.1, world.scan(p, seed=i))
                  for i, p in enumerate(traj)]


@pytest.fixture(scope="module")
def jax_run(frames):
    traj, fr = frames
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jknn, "_chunk_sqdist", exact_sqdist)
        jax.clear_caches()
        robot = jreplay.Robot(JCFG)
        res = jreplay.replay(robot, fr, tick_every=TICK, gt_xyz=traj[:, :3])
    jax.clear_caches()
    return res, _loops(robot)


def _loops(robot):
    kfs = robot.slam.db.uuid_keyframe_map
    return sorted((round(kfs[e.from_uuid].stamp, 3),
                   round(kfs[e.to_uuid].stamp, 3))
                  for e in robot.slam.db.edges if e.type == "loop")


def _jax_covariances(cloud, params):
    """The JAX package's covariances of each cloud (leading dims looped)."""
    pts = cloud.points.reshape(-1, *cloud.points.shape[-2:]).numpy()
    msk = cloud.mask.reshape(-1, cloud.mask.shape[-1]).numpy()
    covs = np.stack([np.array(jreg.make_source(
        JCloud(jnp.asarray(p), jnp.asarray(m)), _REG).covs)
        for p, m in zip(pts, msk)])
    return GICPCloud(cloud.points, cloud.mask, torch.from_numpy(
        covs.reshape(cloud.points.shape + (3,))))


def test_replay_matches_jax(frames, jax_run, monkeypatch, tmp_path):
    traj, fr = frames
    jres, jloops = jax_run
    monkeypatch.setattr(treg, "_covariances", _jax_covariances)
    robot = treplay.Robot(CFG, device="cpu")
    res = treplay.replay(robot, fr, tick_every=TICK, gt_xyz=traj[:, :3],
                         tum_path=str(tmp_path / "t.txt"))
    assert res.trajectory.shape == jres.trajectory.shape == (FRAMES, 7)
    assert len(res.keyframe_trajectory) == len(jres.keyframe_trajectory)
    assert len(res.keyframe_trajectory) >= 12
    assert res.num_loops == jres.num_loops >= 1
    assert _loops(robot) == jloops
    np.testing.assert_allclose(res.trajectory[:, :3], jres.trajectory[:, :3],
                               rtol=0, atol=1e-3)
    assert abs(res.ate - jres.ate) < 1e-3
    assert abs(res.rpe - jres.rpe) < 1e-3
    stamps, poses = load_tum(tmp_path / "t.txt")
    np.testing.assert_allclose(stamps, res.stamps, atol=1e-6)
    np.testing.assert_allclose(poses[:, :3], res.trajectory[:, :3],
                               atol=1e-5)


def test_replay_fused_matches_jax(frames, jax_run):
    traj, fr = frames
    jres, _ = jax_run
    robot = treplay.Robot(CFG, device="cpu")
    res = treplay.replay_fused(robot, fr, tick_every=TICK,
                               gt_xyz=traj[:, :3])
    assert res.trajectory.shape == (FRAMES, 7)
    np.testing.assert_allclose(res.stamps, jres.stamps)
    assert len(res.keyframe_trajectory) == len(jres.keyframe_trajectory)
    assert res.num_loops == jres.num_loops
    assert abs(res.ate - jres.ate) < 0.02
    assert res.ate < 0.3
